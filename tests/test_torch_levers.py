"""The reference's §Perf levers in the port's sharded model, against the
JAX package's own mesh path with the same lever set, on gloo process
groups of CPU ranks.

The setup is ``tests/test_torch_parallel.py``'s: the reference runs in one
subprocess on 8 host CPU devices (``XLA_FLAGS`` set before ``import
jax``; meshes built with ``axis_types=(AxisType.Auto,)*n``), arrays pass
through ``.npz`` files, and the port runs in ranks spawned by
``repro_torch.launch.mesh.run_ranks`` (worlds 2 and 4), each rank writing
its results to a JSON file. Parameters are the reference's
``init_params`` under the lever's own layout (``from_jax_params(ctx=)``)
or the port's seeded init; tokens come from numpy seeds. Everything is
fp32. Cases:

  * serve: ``prefill`` and 4 greedy ``decode_step``s of B 2 sequences on
    (1,2), (2,2) and (1,4) against the reference's mesh ``prefill`` /
    ``decode_step`` under the same lever, on its greedy tokens: logits
    within 1e-4 and the same greedy tokens, for ``serve_2d_tp`` (llama,
    qwen3's untied head, R1's MLA and MoE, zamba2's shared block),
    ``moe_ff_shard`` (phi3.5-moe and R1), ``seq_shard_decode`` (llama on
    (1,2) and (1,4), h2o-danube with its window of 16 inside a 24-token
    cache, zamba2), ``seq_parallel_norm`` (llama on (2,2), llama at S 13 on
    tp 2, a sequence that does not divide, phi3.5-moe, zamba2) and
    ``decode_unroll``; ``serve_2d_tp`` moves no weight in a decode step;
  * ``moe_ff_shard`` with replicated dispatch on (2,2) is held to the
    reference's baseline on the same weights, and the reference's lever is
    shown to differ from that baseline (its fault, ROADMAP §3): it adds
    partial expert products over "data" ranks that hold other tokens;
  * train layout: ``forward`` under ``train_kv_2d`` on (2,2) and (1,4)
    against the reference's; every gradient leaf's rank shard under
    ``train_kv_2d``, ``seq_parallel_norm`` (S 13), ``moe_ff_shard`` and all
    three at once on (2,2) within 1e-5 of its largest element against the
    tp=1 gradient's shard; three ZeRO ``make_train_step`` steps under all
    three against tp=1's under ``tests/test_torch_parallel_train.py``'s
    rule (losses and grad norms within rtol 1e-5, after step 3 at most
    1e-3 of the parameters off by more than 1e-5, each within 4 lr), and
    their checkpoint restored onto the baseline (2,2) layout equals the
    same checkpoint restored onto one device, shard by shard;
  * ``TorchRunner`` on (1,2) under ``seq_parallel_norm`` (prompts of odd
    lengths, chunked) and ``decode_unroll``: greedy tokens equal tp=1's;
    it refuses ``seq_shard_decode``; the model refuses MLA under
    ``seq_shard_decode`` and an int8 or fp8 cache on a real device.

The file takes about 2 minutes in one process; keep it in one xdist
worker (``--dist loadfile``), or each worker reruns its module fixture.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.bridge import from_jax_params
from repro_torch.parallel.sharding import ParallelContext, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOGIT_ATOL = 1e-4
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
# the reference's moe_ff_shard lever against its own baseline: its fault
# moves the served logits by 3 or more (ROADMAP §3); rounding alone, 1e-5
FAULT_MIN = 0.1
DECODE_STEPS = 4
BATCH = 2
PAGE = 4
# name -> (arch, mesh (data, model), prompt length, ParallelContext options,
#          held to the reference's "lever" run or its "baseline")
SERVE_CASES = {
    "serve_2d_tp-llama-2x2": ("llama3.2-3b", (2, 2), 12, {"serve_2d_tp": True}, "lever"),
    "serve_2d_tp-qwen3-2x2": ("qwen3-14b", (2, 2), 12, {"serve_2d_tp": True}, "lever"),
    "serve_2d_tp-r1-2x2": ("deepseek-r1-671b", (2, 2), 12, {"serve_2d_tp": True},
                           "lever"),
    "serve_2d_tp-zamba2-2x2": ("zamba2-2.7b", (2, 2), 12, {"serve_2d_tp": True},
                               "lever"),
    "moe_ff_shard-phi-2x2-replicated": (
        "phi3.5-moe-42b-a6.6b", (2, 2), 12,
        {"moe_ff_shard": True, "moe_dispatch": "replicated"}, "baseline"),
    "moe_ff_shard-r1-2x2-replicated": (
        "deepseek-r1-671b", (2, 2), 12,
        {"moe_ff_shard": True, "moe_dispatch": "replicated"}, "baseline"),
    # auto dispatch: split at prefill (exact in the reference too), the
    # decode's 2 tokens replicated
    "moe_ff_shard-phi-2x2-auto": ("phi3.5-moe-42b-a6.6b", (2, 2), 12,
                                  {"moe_ff_shard": True}, "baseline"),
    "moe_ff_shard-phi-1x2": ("phi3.5-moe-42b-a6.6b", (1, 2), 12,
                             {"moe_ff_shard": True, "moe_dispatch": "replicated"},
                             "lever"),
    "seq_shard_decode-llama-1x2": ("llama3.2-3b", (1, 2), 12,
                                   {"seq_shard_decode": True}, "lever"),
    "seq_shard_decode-llama-1x4": ("llama3.2-3b", (1, 4), 12,
                                   {"seq_shard_decode": True}, "lever"),
    "seq_shard_decode-danube-1x2-window": ("h2o-danube-3-4b", (1, 2), 20,
                                           {"seq_shard_decode": True}, "lever"),
    "seq_shard_decode-zamba2-1x2": ("zamba2-2.7b", (1, 2), 12,
                                    {"seq_shard_decode": True}, "lever"),
    # long_500k's rules (build_ctx): the batch whole, the cache's sequence
    # over "data"; every rank's pool holds both true kv heads
    "seq_shard_decode-zamba2-2x2-cache_seq_data": (
        "zamba2-2.7b", (2, 2), 12,
        {"seq_shard_decode": True, "rules_override": {
            "batch": None, "cache_batch": None, "cache_seq": "data"}}, "lever"),
    "seq_parallel_norm-llama-2x2": ("llama3.2-3b", (2, 2), 12,
                                    {"seq_parallel_norm": True}, "lever"),
    "seq_parallel_norm-llama-1x2-S13": ("llama3.2-3b", (1, 2), 13,
                                        {"seq_parallel_norm": True}, "lever"),
    "seq_parallel_norm-phi-1x2": ("phi3.5-moe-42b-a6.6b", (1, 2), 12,
                                  {"seq_parallel_norm": True}, "lever"),
    "seq_parallel_norm-zamba2-1x2": ("zamba2-2.7b", (1, 2), 12,
                                     {"seq_parallel_norm": True}, "lever"),
    "decode_unroll-llama-2x2": ("llama3.2-3b", (2, 2), 12, {"decode_unroll": True},
                                "lever"),
}
# name -> (arch, mesh, ParallelContext options): the train layout's forward
TRAIN_FORWARD = {
    "train_kv_2d-llama-2x2": ("llama3.2-3b", (2, 2), {"train_kv_2d": True}),
    "train_kv_2d-llama-1x4": ("llama3.2-3b", (1, 4), {"train_kv_2d": True}),
}
TRAIN_SHAPE = dict(B=4, S=16)
TRAIN_LEVERS = ("train_kv_2d", "seq_parallel_norm", "moe_ff_shard")
# name -> (arch, levers set, sequence length) on (2,2)
GRAD_CASES = {
    "llama-train_kv_2d": ("llama3.2-3b", ("train_kv_2d",), 16),
    "llama-seq_parallel_norm-S13": ("llama3.2-3b", ("seq_parallel_norm",), 13),
    "phi-moe_ff_shard": ("phi3.5-moe-42b-a6.6b", ("moe_ff_shard",), 16),
    "phi-all": ("phi3.5-moe-42b-a6.6b", TRAIN_LEVERS, 16),
}
ZERO = dict(arch="phi3.5-moe-42b-a6.6b", B=8, S=16, steps=3, lr=1e-3, warmup=2)
RUNNER_LEVERS = ("seq_parallel_norm", "decode_unroll")

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as T
    from repro.parallel.sharding import ParallelContext

    spec = json.load(open(sys.argv[1]))
    out = sys.argv[2]
    B, steps = spec["batch"], spec["decode_steps"]

    def mesh_of(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    def serve(params, cfg, ctx, mesh, tokens, S):
        params = jax.device_put(params, T.param_shardings(cfg, ctx, "serve"))
        pre = jax.jit(lambda p, t: T.prefill(p, t, cfg, ctx, max_len=S + steps,
                                             cache_dtype=jnp.float32))
        dec = jax.jit(lambda p, st, t: T.decode_step(p, st, t, cfg, ctx))
        last, state = pre(params, jax.device_put(
            jnp.asarray(tokens), NamedSharding(mesh, P(ctx.rules()["batch"], None))))
        logits, fed = [np.asarray(last)], []
        for _ in range(steps):
            nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
            fed.append(nxt)
            lg, state = dec(params, state, jnp.asarray(nxt[:, None]))
            logits.append(np.asarray(lg[:, 0]))
        return np.stack(logits), np.stack(fed)

    for name, (arch, shape, S, opts, held) in spec["serve"].items():
        cfg = get_smoke_config(arch)
        mesh = mesh_of(shape)
        ctx = ParallelContext(mesh=mesh, **opts)
        params = T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="serve",
                               dtype=jnp.float32)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
        arrays = dict(flat(params))
        arrays["@tokens"] = tokens
        arrays["@logits"], arrays["@fed"] = serve(params, cfg, ctx, mesh, tokens, S)
        if held == "baseline":
            base = ParallelContext(mesh=mesh, **{k: v for k, v in opts.items()
                                                 if k == "moe_dispatch"})
            arrays["@base_logits"], arrays["@base_fed"] = serve(
                params, cfg, base, mesh, tokens, S)
        np.savez(os.path.join(out, name + ".npz"), **arrays)

    ts = spec["train_shape"]
    for name, (arch, shape, opts) in spec["train"].items():
        cfg = get_smoke_config(arch)
        mesh = mesh_of(shape)
        ctx = ParallelContext(mesh=mesh, **opts)
        params = jax.device_put(
            T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="train",
                          dtype=jnp.float32), T.param_shardings(cfg, ctx, "train"))
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab, (ts["B"], ts["S"])).astype(np.int32)
        tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
        logits = jax.jit(lambda p, t: T.forward(p, t, cfg, ctx, mode="train")[0])(
            params, tok)
        arrays = dict(flat(params))
        arrays.update({"@tokens": tokens, "@logits": np.asarray(logits)})
        np.savez(os.path.join(out, name + ".npz"), **arrays)
""")


def _write(out, rank, name, result):
    with open(os.path.join(out, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _nest(flat):
    nested = {}
    for k, v in flat.items():
        node = nested
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested


def _rows(ctx, n):
    """This rank's rows of a batch of n (its "data" shard)."""
    d, data = ctx.coords()["data"], ctx.axis_size("data")
    return slice(d * n // data, (d + 1) * n // data)


def _ctx(mesh, opts=()):
    return ParallelContext(mesh=make_test_mesh(*mesh), **dict(opts))


def _tp1_shard(full, name, model):
    """The rank's shard of a tp=1 leaf (``take_shard`` layer by layer)."""
    from repro_torch.models.transformer import take_shard
    axes, ctx = model.axes[name], model.ctx
    lead = sum(1 for a in axes if a == "layers")
    if not lead:
        return take_shard(full, axes, model.cfg, ctx, ctx.coords(), model.layout)
    parts = [take_shard(w, axes[lead:], model.cfg, ctx, ctx.coords(), model.layout)
             for w in full.flatten(0, lead - 1)]
    return torch.stack(parts).view(*full.shape[:lead], *parts[0].shape)


def _serve(m, tokens, fed, S):
    """Prefill and ``len(fed)`` decode steps of this rank's model on its
    rows, each rank's pools holding its share of every sequence's
    positions where the cache's sequence is cut (the split decode)."""
    last, caches, states = m.prefill(tokens)
    B = tokens.shape[0]
    n = S + len(fed)
    blocks = -(-n // PAGE)
    parts, me = 1, 0
    if m.seq_axis is not None:
        parts = m.ctx.axis_size(m.seq_axis)
        me = m.ctx.comm.axis_index(m.seq_axis)
    per = -(-blocks // parts)
    pools = [torch.zeros(s) for s in m.pool_shapes(B * per, PAGE)]
    tables = torch.arange(B * per, dtype=torch.int32).view(B, per)
    pos = torch.arange(me * per * PAGE, min((me + 1) * per * PAGE, S))
    local = pos - me * per * PAGE
    for j, pool in enumerate(pools):
        for b in range(B):
            pool[:, tables[b, local // PAGE].long(), local % PAGE] = torch.stack(
                [c[j][b, pos] for c in caches])
    bufs = [torch.zeros(s, dtype=dt) for s, dt in m.state_shapes(B)]
    for buf, st in zip(bufs, states):
        buf.copy_(st)
    m.ctx.comm.reset()
    got = [last]
    for i, f in enumerate(fed):
        got.append(m.decode_step(torch.from_numpy(f.astype(np.int64)),
                                 torch.full((B,), S + i), pools, tables, bufs,
                                 torch.arange(B)))
    return torch.stack(got).numpy()


# ------------------------------------------------------------------ ranks
def _serve_case(rank, name, case, ref, out):
    arch, mesh, S, opts, held = case
    cfg = get_smoke_config(arch)
    ctx = _ctx(mesh, opts)
    z = np.load(os.path.join(ref, name + ".npz"))
    m = from_jax_params(_nest({k: z[k] for k in z.files if not k.startswith("@")}),
                        cfg, device="cpu", dtype=torch.float32, ctx=ctx)
    rows = _rows(ctx, BATCH) if ctx.spec("batch")[0] else slice(None)
    key = "@base_" if held == "baseline" else "@"
    want, fed = z[key + "logits"][:, rows], z[key + "fed"][:, rows]
    got = _serve(m, torch.from_numpy(z["@tokens"][rows].astype(np.int64)), fed, S)
    stats = ctx.comm.stats
    res = dict(max_abs=float(np.abs(got - want).max()),
               tokens_equal=bool((got[:-1].argmax(-1) == fed).all()),
               finite=bool(np.isfinite(got).all()),
               decode_weight_gathers=stats.get("all_gather", {}).get("weights", 0),
               decode_ops=sorted(stats), kv_heads=m.pool_kv)
    if held == "baseline":
        res["reference_fault"] = float(np.abs(z["@logits"] - z["@base_logits"]).max())
        res["reference_prefill_gap"] = float(
            np.abs(z["@logits"][0] - z["@base_logits"][0]).max())
    _write(out, rank, name, res)


def _train_forward(rank, name, case, ref, out):
    arch, mesh, opts = case
    cfg = get_smoke_config(arch)
    ctx = _ctx(mesh, opts)
    z = np.load(os.path.join(ref, name + ".npz"))
    m = from_jax_params(_nest({k: z[k] for k in z.files if not k.startswith("@")}),
                        cfg, device="cpu", layout="train", ctx=ctx)
    rows = _rows(ctx, TRAIN_SHAPE["B"])
    with torch.no_grad():
        got = m(torch.from_numpy(z["@tokens"][rows].astype(np.int64))).numpy()
    _write(out, rank, name, dict(max_abs=float(np.abs(got - z["@logits"][rows]).max()),
                                 finite=bool(np.isfinite(got).all())))


def _batch(cfg, seed, B, S):
    """A batch of B x S with a mask that leaves the rows different counts."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int64))
    mask = torch.ones((B, S))
    for b in range(B):
        mask[b, S - 1 - b % 3:] = 0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _grads(rank, name, case, out):
    """Every gradient leaf's rank shard under the levers against the tp=1
    gradient's shard, seeded models alike."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.train_step import loss_and_grads
    arch, levers, S = case
    cfg = get_smoke_config(arch)
    ctx = _ctx((2, 2), {k: True for k in levers})
    one = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3, layout="train")
    m = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3, layout="train",
                    ctx=ctx)
    batch = _batch(cfg, 4, TRAIN_SHAPE["B"], S)
    loss1, g1 = loss_and_grads(one, batch)
    loss, g = loss_and_grads(m, {k: v[_rows(ctx, TRAIN_SHAPE["B"])]
                                 for k, v in batch.items()})
    from repro_torch.train.tree import leaves
    full = {id(p): gr for p, gr in zip(leaves(one.param_tree()), g1)}
    full = {n: full[id(p)] for n, p in one.named_parameters()}
    mine = {id(p): gr for p, gr in zip(leaves(m.param_tree()), g)}
    err = {}
    for n, p in m.named_parameters():
        want = _tp1_shard(full[n], n, m)
        err[n] = float((mine[id(p)] - want).abs().max()
                       / max(float(want.abs().max()), 1e-30))
    _write(out, rank, "grads-" + name, dict(err=err, loss=float(loss),
                                            loss_tp1=float(loss1),
                                            ops=sorted(ctx.comm.stats)))


def _zero(rank, work, out):
    """Three ZeRO steps under every train lever against tp=1's, then the
    checkpoint from the lever layout restored onto the baseline (2,2)
    layout and onto one device."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_smoke_config(ZERO["arch"])
    ocfg = AdamWConfig(lr=ZERO["lr"], warmup_steps=ZERO["warmup"])
    ctx = _ctx((2, 2), {k: True for k in TRAIN_LEVERS})
    one = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3, layout="train")
    m = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3, layout="train",
                    ctx=ctx)
    states = [init_opt_state(x.param_tree(), ocfg) for x in (one, m)]
    steps = [make_train_step(x, ocfg) for x in (one, m)]
    rows = _rows(ctx, ZERO["B"])
    res = dict(loss=[], grad_norm=[], loss_tp1=[], grad_norm_tp1=[])
    for i in range(ZERO["steps"]):
        batch = _batch(cfg, 10 + i, ZERO["B"], ZERO["S"])
        a = steps[0](states[0], batch)
        b = steps[1](states[1], {k: v[rows] for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            res[key].append(float(b[key]))
            res[key + "_tp1"].append(float(a[key]))
    tp1 = dict(one.named_parameters())
    off = n = 0
    max_off = 0.0
    for name, p in m.named_parameters():
        d = (p.detach() - _tp1_shard(tp1[name].detach(), name, m)).abs()
        off += int((d > PARAM_ATOL).sum())
        n += d.numel()
        max_off = max(max_off, float(d.max()))
    res.update(off=off, n=n, max_off=max_off)
    path = os.path.join(work, "lever_ckpt")
    ck.save_training(m, states[1], path, ZERO["steps"])
    base = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None, layout="train",
                       ctx=_ctx((2, 2)))
    whole = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None, layout="train")
    ck.restore_training(base, init_opt_state(base.param_tree(), ocfg), path)
    ck.restore_training(whole, init_opt_state(whole.param_tree(), ocfg), path)
    wp = dict(whole.named_parameters())
    res["restore_mismatched"] = [name for name, p in base.named_parameters()
                                 if not torch.equal(p, _tp1_shard(wp[name], name, base))]
    res["restore_vs_trained"] = max(float((wp[k] - tp1[k]).abs().max()) for k in wp)
    _write(out, rank, "zero", res)


def _runner(rank, out):
    """Greedy tokens through the engine and the sharded runner on (1,2)
    under a lever, against the tp=1 port, seeded alike."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import make_requests, serve_sharded
    from repro_torch.models.transformer import Transformer
    cfg = get_smoke_config("llama3.2-3b")
    requests = make_requests(cfg.vocab, 4, (9, 31), (12, 20), seed=4)
    engine = dict(n_pages=64, max_num_seqs=4, max_num_batched_tokens=512,
                  chunk_size=7, admission_mode="naive")
    one = InferenceEngine(cfg, EngineConfig(**engine), TorchRunner(
        Transformer(cfg, device="cpu", dtype=torch.float32, seed=2),
        device="cpu"), virtual_clock=False)
    ones = [one.submit(p, n) for p, n in requests]
    one.run()
    for lever in RUNNER_LEVERS:
        ctx = _ctx((1, 2), {lever: True})
        eng, reqs = serve_sharded(cfg, requests, ctx, device="cpu",
                                  dtype=torch.float32, seed=2, **engine)
        if eng is None:
            continue
        _write(out, rank, "runner-" + lever, dict(
            sharded=[r.output for r in reqs], tp1=[r.output for r in ones],
            lens=[len(p) for p, _ in requests]))
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0,
                        ctx=_ctx((1, 2), {"seq_shard_decode": True}))
    try:
        TorchRunner(model, device="cpu")
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    _write(out, rank, "runner-refuses-seq_shard_decode", dict(refused=refused))


def _world2(rank, ref, work, out):
    for name, case in SERVE_CASES.items():
        if case[1] == (1, 2):
            _serve_case(rank, name, case, ref, out)
    _runner(rank, out)


def _world4(rank, ref, work, out):
    for name, case in SERVE_CASES.items():
        if case[1] != (1, 2):
            _serve_case(rank, name, case, ref, out)
    for name, case in TRAIN_FORWARD.items():
        _train_forward(rank, name, case, ref, out)
    for name, case in GRAD_CASES.items():
        _grads(rank, name, case, out)
    _zero(rank, work, out)


# ------------------------------------------------------------------ fixture
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    work = tmp_path_factory.mktemp("work")
    out = tmp_path_factory.mktemp("ranks")
    spec = ref / "spec.json"
    spec.write_text(json.dumps({"serve": SERVE_CASES, "train": TRAIN_FORWARD,
                                "train_shape": TRAIN_SHAPE, "batch": BATCH,
                                "decode_steps": DECODE_STEPS}))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(spec), str(ref)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for world, fn in ((2, _world2), (4, _world4)):
        run_ranks(fn, world, (str(ref), str(work), str(out)))
    got = {}
    for f in sorted(os.listdir(out)):
        name, rank = f[:-len(".json")].rsplit(".rank", 1)
        got.setdefault(name, {})[int(rank)] = json.loads((out / f).read_text())
    return got


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_lever_serves_as_the_reference_mesh(results, name):
    """Logits within 1e-4 of the reference's run under the same lever (or,
    for ``moe_ff_shard`` on "data" > 1, its baseline) and its greedy
    tokens, on every rank."""
    data, model = SERVE_CASES[name][1]
    ranks = results[name]
    assert len(ranks) == data * model
    for r in ranks.values():
        assert r["finite"], r
        assert r["max_abs"] <= LOGIT_ATOL, ranks
        assert r["tokens_equal"], ranks
    print(name, [r["max_abs"] for r in ranks.values()], ranks[0]["decode_ops"])


@pytest.mark.parametrize("name", [n for n in sorted(SERVE_CASES)
                                  if n.startswith("serve_2d_tp")])
def test_serve_2d_tp_decode_gathers_no_weight(results, name):
    """Decode's GQA, dense-MLP and head products contract over the FSDP
    shards, their partial sums reduce-scattered: llama and qwen3 gather no
    weight; zamba2 only its Mamba2 layers' seven leaves cut over "data",
    and R1 its MLA attention and experts, which the lever leaves as the
    reference's does."""
    mamba = 7 * get_smoke_config("zamba2-2.7b").n_layers * DECODE_STEPS
    for r in results[name].values():
        if "r1" in name:
            assert r["decode_weight_gathers"] > 0
        else:
            assert r["decode_weight_gathers"] == (mamba if "zamba2" in name else 0), r
        assert "reduce_scatter" in r["decode_ops"]


def test_moe_ff_shard_replicated_decode_gathers_no_expert_weight(results):
    """phi3.5-moe's decode under replicated dispatch gathers only its
    attention's four leaves a layer and its untied head, never an expert
    leaf: the experts' partial sums are reduce-scattered instead."""
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    for r in results["moe_ff_shard-phi-2x2-replicated"].values():
        assert r["decode_weight_gathers"] == (4 * cfg.n_layers + 1) * DECODE_STEPS, r
        assert "reduce_scatter" in r["decode_ops"]


@pytest.mark.parametrize("name", [n for n, c in sorted(SERVE_CASES.items())
                                  if c[4] == "baseline"])
def test_reference_moe_ff_shard_departs_from_its_baseline(results, name):
    """The reference's fault (ROADMAP §3): under ``moe_ff_shard`` with
    replicated dispatch on "data" > 1 its logits move far from its
    baseline's on the same weights (with auto dispatch, from the first
    decode step: its prefill splits, which is exact); the port's stay at
    the baseline's."""
    for r in results[name].values():
        assert r["reference_fault"] > FAULT_MIN, r
        assert r["max_abs"] <= LOGIT_ATOL, r
        if name.endswith("auto"):
            assert r["reference_prefill_gap"] <= LOGIT_ATOL, r
    print(name, "reference lever - baseline:", results[name][0]["reference_fault"],
          "at prefill:", results[name][0]["reference_prefill_gap"])


def test_seq_shard_decode_keeps_the_true_kv_heads(results):
    """The cache holds both true kv heads on every rank of (1,4), where the
    baseline tiles them to one a rank."""
    for r in results["seq_shard_decode-llama-1x4"].values():
        assert r["kv_heads"] == 2


@pytest.mark.parametrize("name", sorted(TRAIN_FORWARD))
def test_train_kv_2d_forward_matches_the_reference(results, name):
    ranks = results[name]
    assert len(ranks) == 4
    for r in ranks.values():
        assert r["finite"] and r["max_abs"] <= LOGIT_ATOL, ranks


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_train_lever_gradients_equal_the_tp1_shards(results, name):
    ranks = results["grads-" + name]
    assert len(ranks) == 4
    for r in ranks.values():
        assert r["loss"] == pytest.approx(r["loss_tp1"], rel=LOSS_RTOL)
        bad = {k: e for k, e in r["err"].items() if e > GRAD_RTOL}
        assert not bad, bad
    ops = ranks[0]["ops"]
    if "seq_parallel_norm" in GRAD_CASES[name][1]:
        assert "reduce_scatter" in ops


def test_zero_steps_under_the_train_levers_equal_tp1(results):
    ranks = results["zero"]
    assert len(ranks) == 4
    for r in ranks.values():
        np.testing.assert_allclose(r["loss"], r["loss_tp1"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], r["grad_norm_tp1"], rtol=GRAD_RTOL)
        assert r["off"] <= 1e-3 * r["n"] and r["max_off"] <= 4 * ZERO["lr"], r


def test_lever_checkpoint_restores_onto_the_baseline_layout(results):
    for r in results["zero"].values():
        assert r["restore_mismatched"] == []
        assert r["restore_vs_trained"] <= 4 * ZERO["lr"]


@pytest.mark.parametrize("lever", RUNNER_LEVERS)
def test_sharded_runner_under_a_lever_equals_tp1(results, lever):
    r = results["runner-" + lever][0]
    assert any(n % 2 for n in r["lens"])          # a prompt that does not divide
    assert r["sharded"] == r["tp1"]


def test_runner_refuses_seq_shard_decode(results):
    for r in results["runner-refuses-seq_shard_decode"].values():
        assert r["refused"] and "seq_shard_decode" in r["refused"]


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_a_real_model_refuses_a_quantised_cache(dtype):
    """On the CPU (or a card) an int8 or fp8 cache raises, naming ROADMAP
    §3's question; on meta (the dry-run) the model builds."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import AbstractMesh
    cfg = get_smoke_config("llama3.2-3b")
    ctx = ParallelContext(mesh=AbstractMesh((1, 2), ("data", "model")),
                          kv_cache_dtype=dtype)
    with pytest.raises(NotImplementedError) as e:
        Transformer(cfg, device="cpu", dtype=torch.float32, seed=None, ctx=ctx)
    assert "ROADMAP §3" in str(e.value)
    Transformer(cfg, device="meta", dtype=torch.bfloat16, seed=None, ctx=ctx)


def test_mla_under_seq_shard_decode_is_refused():
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel.sharding import AbstractMesh
    ctx = ParallelContext(mesh=AbstractMesh((1, 2), ("data", "model")),
                          seq_shard_decode=True)
    with pytest.raises(NotImplementedError) as e:
        Transformer(get_smoke_config("deepseek-r1-671b"), device="meta",
                    dtype=torch.bfloat16, seed=None, ctx=ctx)
    assert "ROADMAP §1" in str(e.value)
