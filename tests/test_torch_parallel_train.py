"""The rest of the port's multi-device path against the JAX package's mesh
path, on gloo process groups of CPU ranks: the recurrent-state families
(zamba2, xlstm) served under a mesh, the train layout under a mesh, the
ZeRO train step and the elastic checkpoint restore.

The setup is ``tests/test_torch_parallel.py``'s: the reference runs in a
subprocess on 8 host CPU devices (``XLA_FLAGS`` set before ``import
jax``; meshes built with ``axis_types=(AxisType.Auto,)*n``), arrays pass
through ``.npz`` files, and the port runs in ranks spawned by
``repro_torch.launch.mesh.run_ranks`` (worlds 2 and 4), each rank writing
its results to a JSON file. Inputs come from numpy seeds, from the
reference's ``init_params`` under its mesh (through ``from_jax_params(ctx=,
layout=)``) or from the port's seeded init. Everything is fp32. Cases:

  * serve layout, zamba2 and xlstm smoke configs on (1,2) and (2,2):
    ``prefill`` and 4 greedy ``decode_step``s against the reference's mesh
    ``prefill``/``decode_step``: logits within 1e-4 (xlstm 3e-4, ROADMAP
    §3) and the same greedy tokens; the sharded seeded init equals the
    tp=1 init's shards; the sharded runner's tokens equal tp=1's, with and
    without forced preemption;
  * train layout, ``forward`` of the archs of
    ``tests/test_distributed.py::test_sharded_forward_all_families`` and
    llama3.2-3b on (2,2): logits within 1e-4 of the reference's
    ``forward(mode="train")`` on its mesh (xlstm 3e-4) and within 1e-5 of
    the port's own tp=1 forward on the same weights;
  * train layout, gradients of ``loss_fn`` (a mask that gives the data
    ranks different counts): every leaf's rank shard, after the train
    step's reductions, within 1e-5 of its largest element against the
    shard of the tp=1 gradient (a gradient a factor tp off, or missing a
    rank's share, is off by 0.5 or more);
  * ZeRO: three ``make_train_step`` steps of llama3.2-3b on (2,2) against
    the reference's jitted ``make_train_step(cfg, ctx)`` with
    ``opt_state_shardings``, under ``tests/test_torch_train.py``'s rule:
    losses and grad norms within rtol 1e-5, and after step 1 every
    parameter shard within 1e-5 but for elements whose Adam step flipped
    (their first moment within the gradient's rounding of zero), counted,
    each within 4 lr; after step 3 at most 1e-3 of them off, each within 4
    lr. Each rank's ``m``/``v`` leaf has its parameter shard's shape;
  * elastic restore: the reference writes from (4,2) and the port restores
    onto (2,2) and (1,4); the port writes params and AdamW state from
    (2,2) and the reference restores onto (2,4) with ``shardings=``. Each
    shard is bitwise equal to the written array's slice; a tree padded
    for another tp raises ``ValueError``;
  * the §Perf levers' layouts: under each the sharded model builds in
    either layout, as the reference lays it out; an int8 kv cache is
    refused on a real device, and the runner refuses data > 1
    (``tests/test_torch_levers.py`` holds the levers' computations).

Tolerances of the recurrent stacks against tp=1. Their smoke models are
ill-conditioned: a half-ulp change of every tp=1 weight moves their
logits and gradients by as much as a rank's other summation order does,
where the attention families move by rounding alone. A sharded run cannot
meet 1e-5 there, so each rank measures that conditioning itself (the tp=1
model against a copy with every weight moved by half an ulp, printed
with the errors): for the logits one value, for the gradients one for
each leaf's shard. zamba2 and xlstm are held within ``COND_FACTOR`` times
it (a gradient leaf within the larger of 1e-5 and that), against the
reference within the larger of 1e-4 (xlstm 3e-4) and that, and the
conditioning itself under a fixed ceiling (``LOGIT_COND_CAP``,
``GRAD_COND_CAP``).
"""
import dataclasses
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
from repro_torch.parallel.sharding import (AbstractMesh, ParallelContext,
                                           PERF_LEVERS, make_test_mesh)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOGIT_ATOL = 1e-4
XLSTM_ATOL = 3e-4
TP1_ATOL = 1e-5
GRAD_RTOL = 1e-5
COND_FACTOR = 4.0
# ceilings on the conditioning the ranks measure, so that a change that
# makes the recurrent stacks worse conditioned fails rather than loosening
# its own bound: the largest readings (CPU, fp32) were 8.9e-5 and 3.3e-4
# for the logits, 2.2e-4 and 4.2e-4 for a gradient leaf
LOGIT_COND_CAP = {"zamba2-2.7b": 1.2e-4, "xlstm-350m": 4e-4}
GRAD_COND_CAP = {"zamba2-2.7b": 2.5e-4, "xlstm-350m": 5e-4}
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
DECODE_STEPS = 4
BATCH = 2
RECURRENT = ("zamba2-2.7b", "xlstm-350m")
# name -> (arch, mesh (data, model), prompt length)
SERVE_CASES = {f"{a.split('-')[0]}-{d}x{m}": (a, (d, m), 12)
               for a in RECURRENT for d, m in ((1, 2), (2, 2))}
TRAIN_ARCHS = ["qwen3-14b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "xlstm-350m",
               "musicgen-medium", "kimi-k2-1t-a32b", "llama3.2-3b"]
TRAIN_SHAPE = dict(B=4, S=16)
ZERO = dict(B=8, S=16, steps=3, lr=1e-3, warmup=2)
RUNNER_CASES = [f"{arch}-{pool}" for arch in RECURRENT
                for pool in ("ample", "preempting")]
CKPT_ARCH = "llama3.2-3b"

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as T
    from repro.parallel.sharding import ParallelContext
    from repro.train import checkpoint as ckpt
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step

    spec = json.load(open(sys.argv[1]))
    out = sys.argv[2]
    B, steps = spec["batch"], spec["decode_steps"]

    def mesh_of(shape, names=("data", "model")):
        return jax.make_mesh(tuple(shape), names,
                             axis_types=(AxisType.Auto,) * len(shape))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    def put(tree, cfg, ctx, mode):
        return jax.device_put(tree, T.param_shardings(cfg, ctx, mode))

    if spec["phase"] == "restore":
        # the port's checkpoint of (params, AdamW state), onto (2, 4)
        cfg = get_smoke_config(spec["ckpt_arch"])
        mesh = mesh_of((2, 4))
        ctx = ParallelContext(mesh=mesh)
        ocfg = jopt.AdamWConfig()
        p = T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="train",
                          dtype=jnp.float32)
        like = (p, jopt.init_opt_state(p, ocfg))
        psh = T.param_shardings(cfg, ctx, mode="train")
        (params, opt), step = ckpt.restore(
            like, spec["port_ckpt"], shardings=(psh, jopt.opt_state_shardings(psh, mesh)))
        meshes = {str(dict(a.sharding.mesh.shape)) for a in
                  jax.tree_util.tree_leaves((params, opt))}
        arrays = {"p." + k: v for k, v in flat(params)}
        arrays.update({"m." + k: v for k, v in flat(opt["m"])})
        arrays.update({"v." + k: v for k, v in flat(opt["v"])})
        np.savez(os.path.join(out, "restored.npz"), **arrays)
        json.dump({"step": int(step), "opt_step": int(opt["step"]),
                   "meshes": sorted(meshes),
                   "wq_spec": str(params["dense_stack"]["wq"].sharding.spec)},
                  open(os.path.join(out, "restored.json"), "w"))
        sys.exit(0)

    # serve layout: prefill + greedy decode on the mesh
    for name, (arch, shape, S) in spec["serve"].items():
        cfg = get_smoke_config(arch)
        mesh = mesh_of(shape)
        ctx = ParallelContext(mesh=mesh)
        params = put(T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="serve",
                                   dtype=jnp.float32), cfg, ctx, "serve")
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
        pre = jax.jit(lambda p, t: T.prefill(p, t, cfg, ctx, max_len=S + steps,
                                             cache_dtype=jnp.float32))
        dec = jax.jit(lambda p, st, t: T.decode_step(p, st, t, cfg, ctx))
        last, state = pre(params, jax.device_put(
            jnp.asarray(tokens), NamedSharding(mesh, P("data", None))))
        logits, fed = [np.asarray(last)], []
        for _ in range(steps):
            nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
            fed.append(nxt)
            lg, state = dec(params, state, jnp.asarray(nxt[:, None]))
            logits.append(np.asarray(lg[:, 0]))
        arrays = dict(flat(params))
        arrays.update({"@tokens": tokens, "@logits": np.stack(logits),
                       "@fed": np.stack(fed)})
        np.savez(os.path.join(out, name + ".npz"), **arrays)

    # train layout: the forward of every family on (2, 2)
    ts = spec["train_shape"]
    mesh = mesh_of((2, 2))
    ctx = ParallelContext(mesh=mesh)
    for arch in spec["train_archs"]:
        cfg = get_smoke_config(arch)
        params = put(T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="train",
                                   dtype=jnp.float32), cfg, ctx, "train")
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab, (ts["B"], ts["S"])).astype(np.int32)
        tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
        logits = jax.jit(lambda p, t: T.forward(p, t, cfg, ctx, mode="train")[0])(
            params, tok)
        arrays = dict(flat(params))
        arrays.update({"@tokens": tokens, "@logits": np.asarray(logits)})
        np.savez(os.path.join(out, "train-" + arch + ".npz"), **arrays)

    # ZeRO: three jitted sharded train steps of llama3.2-3b on (2, 2)
    z = spec["zero"]
    cfg = get_smoke_config("llama3.2-3b")
    ocfg = jopt.AdamWConfig(lr=z["lr"], warmup_steps=z["warmup"])
    psh = T.param_shardings(cfg, ctx, mode="train")
    params = jax.device_put(T.init_params(cfg, jax.random.PRNGKey(0), ctx,
                                          mode="train", dtype=jnp.float32), psh)
    opt = jax.device_put(jopt.init_opt_state(params, ocfg),
                         jopt.opt_state_shardings(psh, mesh))
    step = jax.jit(make_train_step(cfg, ctx, ocfg))
    vg = jax.jit(jax.value_and_grad(lambda p, b: T.loss_fn(p, b, cfg, ctx)))
    rng = np.random.default_rng(2)
    arrays = {"p0." + k: v for k, v in flat(params)}
    metrics = []
    for i in range(z["steps"]):
        toks = rng.integers(0, cfg.vocab, (z["B"], z["S"] + 1)).astype(np.int32)
        mask = np.ones((z["B"], z["S"]), np.float32)
        for b in range(z["B"]):
            mask[b, z["S"] - 1 - b % 3 - i:] = 0
        arrays.update({f"@tokens{i}": toks, f"@mask{i}": mask})
        sh = NamedSharding(mesh, P("data", None))
        batch = {"tokens": jax.device_put(jnp.asarray(toks[:, :-1]), sh),
                 "labels": jax.device_put(jnp.asarray(toks[:, 1:]), sh),
                 "mask": jax.device_put(jnp.asarray(mask), sh)}
        if i == 0:
            _, g = vg(params, batch)
            arrays.update({"g0." + k: v for k, v in flat(g)})
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        arrays.update({f"p{i + 1}." + k: v for k, v in flat(params)})
        arrays.update({f"m{i + 1}." + k: v for k, v in flat(opt["m"])})
    assert params["dense_stack"]["wq"].sharding == opt["m"]["dense_stack"]["wq"].sharding
    np.savez(os.path.join(out, "zero.npz"), **arrays)
    json.dump(metrics, open(os.path.join(out, "zero.json"), "w"))

    # a checkpoint written from (4, 2) for the port's elastic restore
    cfg = get_smoke_config(spec["ckpt_arch"])
    ctx = ParallelContext(mesh=mesh_of((4, 2)))
    p = put(T.init_params(cfg, jax.random.PRNGKey(5), ctx, mode="train",
                          dtype=jnp.float32), cfg, ctx, "train")
    ckpt.save(p, os.path.join(out, "ref_ckpt"), step=3)
""")


def _write(out, rank, name, result):
    with open(os.path.join(out, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _tree(z, prefix=""):
    """The arrays of ``z`` whose names start with ``prefix`` (but "@"
    inputs), nested by the dotted rest of their names."""
    return _nest({k[len(prefix):]: z[k] for k in z.files
                  if k.startswith(prefix) and not k.startswith("@")})


def _rows(ctx, n):
    """This rank's rows of a batch of n (its "data" shard)."""
    d, data = ctx.coords()["data"], ctx.axis_size("data")
    return slice(d * n // data, (d + 1) * n // data)


def _places(model):
    """{dotted name: Placement} of a model's parameters."""
    from repro_torch.train.tree import flatten_with_path
    return {".".join(path): pl for path, pl in flatten_with_path(model.placements())}


def _shard_of(arr, place, ctx):
    from repro_torch.parallel.sharding import entry_slices
    return arr[entry_slices(arr.shape, place.entries, ctx, ctx.coords())]


def _tp1_shard(full, name, model):
    """The rank's shard of a tp=1 leaf (``take_shard`` layer by layer)."""
    from repro_torch.models.transformer import take_shard
    axes = model.axes[name]
    lead = sum(1 for a in axes if a == "layers")
    ctx = model.ctx
    if not lead:
        return take_shard(full, axes, model.cfg, ctx, ctx.coords(), model.layout)
    parts = [take_shard(w, axes[lead:], model.cfg, ctx, ctx.coords(), model.layout)
             for w in full.flatten(0, lead - 1)]
    return torch.stack(parts).view(*full.shape[:lead], *parts[0].shape)


def _perturbed(model):
    """A copy of a tp=1 model with every weight moved by half an ulp, up or
    down at random (seeded)."""
    import copy
    twin = copy.deepcopy(model)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in twin.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
            p.mul_(1 + sign * 2.0 ** -24)
    return twin


def _mesh(data, model):
    return make_test_mesh(data, model)


# ------------------------------------------------------------------ ranks
def _serve(rank, name, case, ref, out):
    """Serve-layout prefill and decode of this rank's shard against the
    reference's logits, on its greedy tokens, the recurrent state in slot
    buffers of the model's ``state_shapes``."""
    arch, (data, model), S = case
    cfg = get_smoke_config(arch)
    ctx = ParallelContext(mesh=_mesh(data, model))
    z = np.load(os.path.join(ref, name + ".npz"))
    m = from_jax_params(_tree(z), cfg, device="cpu", dtype=torch.float32, ctx=ctx)
    rows = _rows(ctx, BATCH)
    tokens = torch.from_numpy(z["@tokens"][rows].astype(np.int64))
    want, fed = z["@logits"][:, rows], z["@fed"][:, rows]
    last, caches, states = m.prefill(tokens)
    B, page = tokens.shape[0], 4
    per = -(-(S + DECODE_STEPS) // page)
    pools = [torch.zeros(s) for s in m.pool_shapes(B * per, page)]
    tables = torch.arange(B * per, dtype=torch.int32).view(B, per)
    pos = torch.arange(S)
    for j, pool in enumerate(pools):
        for b in range(B):
            pool[:, tables[b, pos // page].long(), pos % page] = torch.stack(
                [c[j][b] for c in caches])
    bufs = [torch.zeros(s, dtype=dt) for s, dt in m.state_shapes(B)]
    for buf, st in zip(bufs, states):
        buf.copy_(st)
    got = [last]
    for i in range(DECODE_STEPS):
        got.append(m.decode_step(torch.from_numpy(fed[i].astype(np.int64)),
                                 torch.full((B,), S + i), pools, tables, bufs,
                                 torch.arange(B)))
    got = torch.stack(got).numpy()
    _write(out, rank, name, dict(
        max_abs=float(np.abs(got - want).max()),
        tokens_equal=bool((got[:-1].argmax(-1) == fed).all()),
        finite=bool(np.isfinite(got).all()), shape=list(got.shape),
        want_shape=list(want.shape),
        state_shapes=[list(s) for s, _ in m.state_shapes(1)]))


def _seeded_init(rank, name, arch, data, model, layout, out):
    """The sharded seeded init holds the shards of the tp=1 seeded init."""
    from repro_torch.models.transformer import Transformer
    cfg = get_smoke_config(arch)
    ctx = ParallelContext(mesh=_mesh(data, model))
    one = dict(Transformer(cfg, device="cpu", dtype=torch.float32, seed=5,
                           layout=layout).named_parameters())
    sharded = Transformer(cfg, device="cpu", dtype=torch.float32, seed=5,
                          layout=layout, ctx=ctx)
    bad = [n for n, p in sharded.named_parameters()
           if not torch.equal(_tp1_shard(one[n], n, sharded), p.data)]
    _write(out, rank, name, dict(mismatched=bad))


def _runner(rank, out):
    """Greedy tokens through the engine and the sharded runner on (1,2)
    against the tp=1 port, seeded alike."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import make_requests, serve_sharded
    from repro_torch.models.transformer import Transformer
    ctx = ParallelContext(mesh=_mesh(1, 2))
    for case in RUNNER_CASES:
        arch, pool = case.rsplit("-", 1)
        cfg = get_smoke_config(arch)
        requests = make_requests(cfg.vocab, 4, (10, 30), (12, 20), seed=4)
        engine = dict(n_pages=64 if pool == "ample" else 7, max_num_seqs=4,
                      max_num_batched_tokens=512, chunk_size=192,
                      admission_mode="naive")
        eng, reqs = serve_sharded(cfg, requests, ctx, device="cpu",
                                  dtype=torch.float32, seed=2, **engine)
        if eng is None:
            continue
        one = InferenceEngine(cfg, EngineConfig(**engine), TorchRunner(
            Transformer(cfg, device="cpu", dtype=torch.float32, seed=2),
            device="cpu"), virtual_clock=False)
        ones = [one.submit(p, n) for p, n in requests]
        one.run()
        _write(out, rank, "runner-" + case, dict(
            sharded=[r.output for r in reqs], tp1=[r.output for r in ones],
            preemptions=sum(r.n_preemptions for r in reqs),
            finished=all(len(r.output) == n for r, (_, n) in zip(reqs, requests))))


def _train_forward(rank, arch, ref, out):
    """The train layout's forward of this rank's rows against the
    reference's mesh forward and the port's tp=1 forward on the same
    weights; for the recurrent stacks also the tp=1 model's conditioning."""
    cfg = get_smoke_config(arch)
    ctx = ParallelContext(mesh=_mesh(2, 2))
    z = np.load(os.path.join(ref, "train-" + arch + ".npz"))
    m = from_jax_params(_tree(z), cfg, device="cpu", layout="train", ctx=ctx)
    one = from_jax_params(_tree(z), cfg, device="cpu", layout="train")
    rows = _rows(ctx, TRAIN_SHAPE["B"])
    tok = torch.from_numpy(z["@tokens"].astype(np.int64))
    with torch.no_grad():
        got, tp1 = m(tok[rows]).numpy(), one(tok)[rows].numpy()
        cond = (float(np.abs(_perturbed(one)(tok)[rows].numpy() - tp1).max())
                if arch in RECURRENT else None)
    want = z["@logits"][rows]
    _write(out, rank, "train-" + arch, dict(
        ref=float(np.abs(got - want).max()),
        tp1_ref=float(np.abs(tp1 - want).max()),
        tp1=float(np.abs(got - tp1).max()), cond=cond,
        finite=bool(np.isfinite(got).all()), shape=list(got.shape)))


def _batch(cfg, seed, B, S):
    """A batch of B x S with a mask that leaves the rows different counts."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int64))
    mask = torch.ones((B, S))
    for b in range(B):
        mask[b, S - 1 - b % 3:] = 0
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _train_grads(rank, arch, out):
    """Every gradient leaf's rank shard, as the train step reduces it,
    against the tp=1 gradient's shard, seeded models alike."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.train_step import loss_and_grads
    cfg = get_smoke_config(arch)
    ctx = ParallelContext(mesh=_mesh(2, 2))
    one = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3, layout="train")
    m = Transformer(cfg, device="cpu", dtype=torch.float32, seed=3, layout="train",
                    ctx=ctx)
    batch = _batch(cfg, 4, TRAIN_SHAPE["B"], TRAIN_SHAPE["S"])
    rows = _rows(ctx, TRAIN_SHAPE["B"])
    loss1, g1 = loss_and_grads(one, batch)
    loss, g = loss_and_grads(m, {k: v[rows] for k, v in batch.items()})
    names = list(_places(m))
    full = dict(zip(list(_places(one)), g1))
    err = {}
    for n, gr in zip(names, g):
        want = _tp1_shard(full[n], n, m)
        err[n] = float((gr - want).abs().max() / max(float(want.abs().max()), 1e-30))
    cond = {}
    if arch in RECURRENT:
        _, g2 = loss_and_grads(_perturbed(one), batch)
        for n, a, b in zip(_places(one), g1, g2):
            a, b = _tp1_shard(a, n, m), _tp1_shard(b, n, m)
            cond[n] = float((a - b).abs().max() / max(float(a.abs().max()), 1e-30))
    _write(out, rank, "grads-" + arch, dict(
        err=err, cond=cond, loss=float(loss), loss_tp1=float(loss1)))


def _zero(rank, ref, work, out):
    """Three ``make_train_step`` steps on (2,2) from the reference's
    parameters against its jitted sharded steps; then the port writes its
    (params, AdamW state) checkpoint from (2,2) and its shards beside it."""
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import flatten_with_path
    cfg = get_smoke_config("llama3.2-3b")
    ctx = ParallelContext(mesh=_mesh(2, 2))
    z = np.load(os.path.join(ref, "zero.npz"))
    with open(os.path.join(ref, "zero.json")) as f:
        jm = json.load(f)
    m = from_jax_params(_tree(z, "p0."), cfg, device="cpu", layout="train", ctx=ctx)
    ocfg = AdamWConfig(lr=ZERO["lr"], warmup_steps=ZERO["warmup"])
    state = init_opt_state(m.param_tree(), ocfg)
    step = make_train_step(m, ocfg)
    places = _places(m)
    rows = _rows(ctx, ZERO["B"])
    res = dict(loss=[], grad_norm=[], lr=[], flips=0, n=0, bad=[], off3=0,
               max_off=0.0, m_err=0.0)
    for i in range(ZERO["steps"]):
        toks = torch.from_numpy(z[f"@tokens{i}"][rows].astype(np.int64))
        met = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                           "mask": torch.from_numpy(z[f"@mask{i}"][rows])})
        for k in ("loss", "grad_norm", "lr"):
            res[k].append(float(met[k]))
        params = dict(m.named_parameters())
        if i == 0:
            scale = min(1.0, 1.0 / jm[0]["grad_norm"])
            for n, p in params.items():
                want = _shard_of(z["p1." + n], places[n], ctx)
                m_ref = _shard_of(z["m1." + n], places[n], ctx)
                d = np.abs(p.detach().numpy() - want)
                off = d > PARAM_ATOL
                m_tol = (1 - 0.9) * scale * GRAD_RTOL * float(np.abs(z["g0." + n]).max())
                if (off & (np.abs(m_ref) > m_tol)).any() or (off.any() and d.max() > 4 * ZERO["lr"]):
                    res["bad"].append(n)
                res["flips"] += int(off.sum())
                res["n"] += d.size
                mine_m = dict(flatten_with_path(state["m"]))
                mm = mine_m[tuple(n.split("."))].numpy()
                res["m_err"] = max(res["m_err"], float(np.abs(mm - m_ref).max()
                                                       / max(float(np.abs(m_ref).max()), 1e-30)))
    for n, p in dict(m.named_parameters()).items():
        d = np.abs(p.detach().numpy() - _shard_of(z[f"p{ZERO['steps']}." + n],
                                                  places[n], ctx))
        res["off3"] += int((d > PARAM_ATOL).sum())
        res["max_off"] = max(res["max_off"], float(d.max()))
    pshapes = {".".join(k): list(v.shape) for k, v in flatten_with_path(m.param_tree())}
    res["moments_match_shards"] = all(
        {".".join(k): list(v.shape) for k, v in flatten_with_path(state[key])} == pshapes
        for key in ("m", "v"))
    res["step"] = int(state["step"])
    res["ref"] = jm
    ck.save_training(m, state, os.path.join(work, "port_ckpt"), ZERO["steps"])
    shards = {"p." + n: p.detach().numpy() for n, p in m.named_parameters()}
    for key in ("m", "v"):
        shards.update({f"{key}." + ".".join(k): v.numpy()
                       for k, v in flatten_with_path(state[key])})
    np.savez(os.path.join(work, f"port-shards.rank{rank}.npz"), **shards)
    with open(os.path.join(work, f"port-coords.rank{rank}.json"), "w") as f:
        json.dump(ctx.coords(), f)
    _write(out, rank, "zero", res)


def _restore(rank, ref, work, out):
    """The reference's checkpoint (written from (4,2)) restored onto (2,2)
    and (1,4); a tree padded for tp 2 refused on tp 4."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import checkpoint as ck
    cfg = get_smoke_config(CKPT_ARCH)
    src = os.path.join(ref, "ref_ckpt")
    d = os.path.join(src, "step-000000003")
    with open(os.path.join(d, "manifest.json")) as f:
        keys = json.load(f)["keys"]
    with np.load(os.path.join(d, "arrays.npz")) as data:
        whole = {k.replace("/", "."): data[f"a{i}"] for i, k in enumerate(keys)}
    for data_, model_ in ((2, 2), (1, 4)):
        ctx = ParallelContext(mesh=_mesh(data_, model_))
        m = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None,
                        layout="train", ctx=ctx)
        tree, step = ck.restore(m.param_tree(), src, placements=m.placements(),
                                ctx=ctx)
        from repro_torch.train.tree import flatten_with_path
        places = _places(m)
        bad = [".".join(k) for k, v in flatten_with_path(tree)
               if not np.array_equal(v.numpy(), _shard_of(whole[".".join(k)],
                                                          places[".".join(k)], ctx))]
        _write(out, rank, f"restore-{data_}x{model_}", dict(
            step=step, mismatched=bad, n=len(keys)))
    # the port's own (params, AdamW state) checkpoint from (2,2), onto (1,4)
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.tree import leaves
    ctx = ParallelContext(mesh=_mesh(1, 4))
    m = Transformer(get_smoke_config("llama3.2-3b"), device="cpu",
                    dtype=torch.float32, seed=None, layout="train", ctx=ctx)
    state, step = ck.restore_training(m, init_opt_state(m.param_tree(),
                                                        AdamWConfig()),
                                      os.path.join(work, "port_ckpt"))
    d = os.path.join(work, "port_ckpt", f"step-{ZERO['steps']:09d}")
    tree = (m.param_tree(), state)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        bad = [i for i, (leaf, place) in enumerate(zip(
            leaves(tree), leaves(ck.training_placements(m))))
            if not (tuple(leaf.shape) == tuple(_shard_of(data[f"a{i}"], place, ctx).shape)
                    and np.array_equal(leaf.numpy(), _shard_of(data[f"a{i}"], place, ctx)))]
    _write(out, rank, "restore-port-1x4", dict(
        step=step, opt_step=int(state["step"]), mismatched=bad,
        n=len(leaves(tree))))
    cfg6 = dataclasses.replace(cfg, n_heads=6)
    ctx = ParallelContext(mesh=_mesh(2, 2))
    m6 = Transformer(cfg6, device="cpu", dtype=torch.float32, seed=1,
                     layout="train", ctx=ctx)
    pad = os.path.join(work, "pad_ckpt")
    ck.save(m6.param_tree(), pad, 1, placements=m6.placements(), ctx=ctx)
    ctx4 = ParallelContext(mesh=_mesh(1, 4))
    m64 = Transformer(cfg6, device="cpu", dtype=torch.float32, seed=None,
                      layout="train", ctx=ctx4)
    try:
        ck.restore(m64.param_tree(), pad, placements=m64.placements(), ctx=ctx4)
        refused = None
    except ValueError as e:
        refused = str(e)
    _write(out, rank, "restore-padded", dict(refused=refused))


def _world2(rank, ref, work, out):
    for name, case in SERVE_CASES.items():
        if case[1] == (1, 2):
            _serve(rank, name, case, ref, out)
    for arch in RECURRENT:
        _seeded_init(rank, f"init-{arch}-1x2-serve", arch, 1, 2, "serve", out)
    _runner(rank, out)


def _world4(rank, ref, work, out):
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models.transformer import Transformer
    for name, case in SERVE_CASES.items():
        if case[1] == (2, 2):
            _serve(rank, name, case, ref, out)
    for arch, layout in (("xlstm-350m", "serve"), ("zamba2-2.7b", "train"),
                         ("llama3.2-3b", "train")):
        _seeded_init(rank, f"init-{arch}-2x2-{layout}", arch, 2, 2, layout, out)
    for arch in TRAIN_ARCHS:
        _train_forward(rank, arch, ref, out)
        _train_grads(rank, arch, out)
    _zero(rank, ref, work, out)
    _restore(rank, ref, work, out)
    ctx = ParallelContext(mesh=_mesh(2, 2))
    model = Transformer(get_smoke_config("zamba2-2.7b"), device="cpu",
                        dtype=torch.float32, seed=0, ctx=ctx)
    try:
        TorchRunner(model, device="cpu")
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    _write(out, rank, "runner-refuses-data2", dict(refused=refused))


# ------------------------------------------------------------------ fixture
def _reference(spec, ref):
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    path = ref / f"spec-{spec['phase']}.json"
    path.write_text(json.dumps(spec))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path), str(ref)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    work = tmp_path_factory.mktemp("work")
    out = tmp_path_factory.mktemp("ranks")
    _reference({"phase": "run", "serve": SERVE_CASES, "train_archs": TRAIN_ARCHS,
                "train_shape": TRAIN_SHAPE, "zero": ZERO, "batch": BATCH,
                "decode_steps": DECODE_STEPS, "ckpt_arch": CKPT_ARCH}, ref)
    for world, fn in ((2, _world2), (4, _world4)):
        run_ranks(fn, world, (str(ref), str(work), str(out)))
    _reference({"phase": "restore", "ckpt_arch": CKPT_ARCH, "batch": BATCH,
                "decode_steps": DECODE_STEPS,
                "port_ckpt": str(work / "port_ckpt")}, ref)
    got = {}
    for f in sorted(os.listdir(out)):
        name, rank = f[:-len(".json")].rsplit(".rank", 1)
        got.setdefault(name, {})[int(rank)] = json.loads((out / f).read_text())
    got["@ref"], got["@work"] = ref, work
    return got


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_recurrent_serve_layout_matches_the_reference_mesh(results, name):
    arch, (data, model), _ = SERVE_CASES[name]
    ranks = results[name]
    assert len(ranks) == data * model
    atol = XLSTM_ATOL if arch == "xlstm-350m" else LOGIT_ATOL
    for r in ranks.values():
        assert r["finite"] and r["shape"] == r["want_shape"], r
        assert r["max_abs"] <= atol, ranks
        assert r["tokens_equal"], ranks
    if arch == "zamba2-2.7b":
        # h over the rank's heads, the conv state of x over its channels
        h, conv_x = ranks[0]["state_shapes"][:2]
        assert h[2] == 8 // model and conv_x[-1] == 128 // model


@pytest.mark.parametrize("name", [f"init-{a}-1x2-serve" for a in RECURRENT]
                         + ["init-xlstm-350m-2x2-serve", "init-zamba2-2.7b-2x2-train",
                            "init-llama3.2-3b-2x2-train"])
def test_seeded_init_is_the_tp1_model(results, name):
    ranks = results[name]
    assert ranks
    for r in ranks.values():
        assert r["mismatched"] == []


@pytest.mark.parametrize("case", RUNNER_CASES)
def test_sharded_recurrent_runner_tokens_equal_tp1(results, case):
    r = results["runner-" + case][0]
    assert r["finished"]
    assert r["sharded"] == r["tp1"]
    if case.endswith("preempting"):
        assert r["preemptions"] > 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_forward_matches_the_reference_mesh_and_tp1(results, arch):
    ranks = results["train-" + arch]
    assert len(ranks) == 4
    atol = XLSTM_ATOL if arch == "xlstm-350m" else LOGIT_ATOL
    for r in ranks.values():
        assert r["finite"] and r["shape"][0] == TRAIN_SHAPE["B"] // 2, r
        if arch in RECURRENT:
            # rounding alone moves these logits by cond (module docstring)
            assert r["cond"] <= LOGIT_COND_CAP[arch], ranks
            assert r["ref"] <= max(atol, COND_FACTOR * r["cond"]), ranks
            assert r["tp1"] <= COND_FACTOR * r["cond"], ranks
        else:
            assert r["ref"] <= atol, ranks
            assert r["tp1"] <= TP1_ATOL, ranks
    print(arch, {k: [r[k] for r in ranks.values()]
                 for k in ("ref", "tp1_ref", "tp1", "cond")})


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_gradients_equal_the_tp1_shards(results, arch):
    ranks = results["grads-" + arch]
    assert len(ranks) == 4
    for r in ranks.values():
        for name, err in r["err"].items():
            bound = GRAD_RTOL
            if arch in RECURRENT:
                # rounding alone moves this leaf by its cond (module docstring)
                cond = r["cond"][name]
                assert cond <= GRAD_COND_CAP[arch], (arch, name, cond)
                bound = max(GRAD_RTOL, COND_FACTOR * cond)
            assert err <= bound, (arch, name, err, bound)
        np.testing.assert_allclose(r["loss"], r["loss_tp1"], rtol=1e-6)
    print(arch, "worst gradient shard error by rank",
          [max(r["err"].values()) for r in ranks.values()],
          "worst leaf conditioning",
          [max(r["cond"].values(), default=None) for r in ranks.values()])


def test_zero_steps_match_the_reference_sharded_step(results):
    ranks = results["zero"]
    assert len(ranks) == 4
    for r in ranks.values():
        jm = r["ref"]
        np.testing.assert_allclose(r["loss"], [m["loss"] for m in jm], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], [m["grad_norm"] for m in jm],
                                   rtol=GRAD_RTOL)
        np.testing.assert_allclose(r["lr"], [m["lr"] for m in jm], rtol=1e-7)
        assert r["step"] == ZERO["steps"]
        # step 1: every element within PARAM_ATOL but for counted flips
        assert r["bad"] == [], r["bad"]
        assert r["flips"] <= 1e-3 * r["n"], r["flips"]
        assert r["m_err"] <= 2 * GRAD_RTOL, r["m_err"]
        # step 3, free-running from the port's own state
        assert r["off3"] <= 1e-3 * r["n"] and r["max_off"] <= 4 * ZERO["lr"], r
    print("ZeRO: flips at step 1 by rank",
          [r["flips"] for r in ranks.values()], "of", ranks[0]["n"])


def test_zero_moments_have_their_parameter_shards_shapes(results):
    for r in results["zero"].values():
        assert r["moments_match_shards"]


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_elastic_restore_reference_to_port(results, shape):
    ranks = results["restore-" + shape]
    assert len(ranks) == 4
    for r in ranks.values():
        assert r["step"] == 3 and r["n"] > 0 and r["mismatched"] == [], r


def test_elastic_restore_port_to_port_with_adamw_state(results):
    """The port's (params, AdamW state) checkpoint written from (2,2)
    restores onto (1,4): every leaf, the 0-d step too, is its slice of
    the written array, shape and bits."""
    ranks = results["restore-port-1x4"]
    assert len(ranks) == 4
    for r in ranks.values():
        assert r["step"] == r["opt_step"] == ZERO["steps"], r
        assert r["n"] > 0 and r["mismatched"] == [], r


def test_elastic_restore_port_to_reference(results):
    """The reference's restore onto (2,4) holds, bitwise, every array whose
    shards the port's (2,2) ranks held when they wrote it."""
    from repro_torch.parallel.sharding import entry_slices
    from repro_torch.models.transformer import Transformer
    ref, work = results["@ref"], results["@work"]
    meta = json.loads((ref / "restored.json").read_text())
    assert meta["step"] == meta["opt_step"] == ZERO["steps"]
    assert meta["meshes"] == [str({"data": 2, "model": 4})]
    restored = np.load(ref / "restored.npz")
    cfg = get_smoke_config(CKPT_ARCH)
    ctx = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")))
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=None,
                        layout="train", ctx=ctx)
    places = _places(model)
    checked = 0
    for rank in range(4):
        coords = json.loads((work / f"port-coords.rank{rank}.json").read_text())
        shards = np.load(work / f"port-shards.rank{rank}.npz")
        for key in shards.files:
            kind, name = key.split(".", 1)
            whole = restored[f"{kind}.{name}"]
            sl = entry_slices(whole.shape, places[name].entries, ctx, coords)
            assert np.array_equal(whole[sl], shards[key]), key
            checked += 1
    assert checked == 4 * 3 * len(places)


def test_restore_refuses_a_tree_padded_for_another_tp(results):
    for r in results["restore-padded"].values():
        assert r["refused"] and "structure mismatch" in r["refused"]


def test_recurrent_runner_refuses_data_above_one(results):
    for r in results["runner-refuses-data2"].values():
        assert r["refused"] and "data" in r["refused"]


# ------------------------------------------------ layouts and refusals, no group
SPEC_ARCHS = ["llama3.2-3b", "qwen3-14b", "h2o-danube-3-4b", "musicgen-medium",
              "internvl2-76b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
              "deepseek-r1-671b", "zamba2-2.7b", "xlstm-350m"]


def _jax_flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _jax_flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("tp", [2, 4, 8, 16])
@pytest.mark.parametrize("layout", ["serve", "train"])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_layout_matches_the_reference_specs(arch, layout, tp, data):
    """The full-size config's padded shapes, logical axes and mesh specs in
    either layout equal the reference's ``build_param_specs`` /
    ``param_pspecs`` under an abstract (data, tp) mesh, with the baseline
    rules and under each §Perf lever, and the model accepts it
    (``check_shardable``; it refuses MLA's serve layout under
    ``seq_shard_decode`` alone)."""
    from jax.sharding import AbstractMesh as JaxAbstractMesh
    from repro.configs.registry import get_config as jax_config
    from repro.models import transformer as T
    from repro.parallel import sharding as ref
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import (check_shardable, padded_shapes,
                                                param_axes)
    shape, names = (data, tp), ("data", "model")
    cfg = get_config(arch)
    for lever in (None, *PERF_LEVERS):
        kw = {lever: True} if lever else {}
        jctx = ref.ParallelContext(mesh=JaxAbstractMesh(shape, names), **kw)
        tctx = ParallelContext(mesh=AbstractMesh(shape, names), **kw)
        specs = dict(_jax_flat(T.build_param_specs(jax_config(arch), jctx, layout)))
        pspecs = dict(_jax_flat(T.param_pspecs(jax_config(arch), jctx, layout)))
        shapes, axes = padded_shapes(cfg, tctx, layout), param_axes(cfg, layout, tctx)
        assert set(shapes) == set(specs), lever
        for name, spec in specs.items():
            assert shapes[name] == spec.shape, (lever, name)
            assert axes[name] == spec.axes, (lever, name)
            assert tctx.spec(*axes[name]) == tuple(pspecs[name]), (lever, name)
        if (lever == "seq_shard_decode" and layout == "serve"
                and cfg.attention == "mla"):
            with pytest.raises(NotImplementedError, match="ROADMAP §1"):
                check_shardable(cfg, tctx, layout)
        else:
            check_shardable(cfg, tctx, layout)


@pytest.mark.parametrize("lever", [*PERF_LEVERS, "remat", "kv_cache_dtype"])
@pytest.mark.parametrize("layout", ["serve", "train"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-2.7b", "xlstm-350m"])
def test_the_sharded_model_refuses_each_lever(arch, layout, lever):
    """Under a (1,2) mesh the model takes every §Perf lever in either
    layout: it builds, and its padded shapes, logical axes and mesh specs
    equal the reference's ``build_param_specs`` / ``param_pspecs`` under
    the same lever, its parameters those shapes' rank shards. An int8 kv
    cache is the refusal that remains: a real (CPU) model raises, naming
    ROADMAP §3's question; on meta, the dry-run's count, it builds."""
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh as JaxAbstractMesh
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import transformer as T
    from repro.parallel import sharding as ref
    from repro_torch.models.transformer import (Transformer, padded_shapes,
                                                param_axes)
    from repro_torch.parallel.sharding import shard_shape
    kw = {"remat": "full"} if lever == "remat" else \
        {"kv_cache_dtype": torch.int8} if lever == "kv_cache_dtype" else {lever: True}
    jkw = {"kv_cache_dtype": jnp.int8} if lever == "kv_cache_dtype" else kw
    ctx = ParallelContext(mesh=AbstractMesh((1, 2), ("data", "model")), **kw)
    jctx = ref.ParallelContext(mesh=JaxAbstractMesh((1, 2), ("data", "model")), **jkw)
    cfg = get_smoke_config(arch)
    device = "cpu"
    if lever == "kv_cache_dtype":
        with pytest.raises(NotImplementedError) as e:
            Transformer(cfg, device="cpu", dtype=torch.float32, seed=None,
                        layout=layout, ctx=ctx)
        assert lever in str(e.value) and "ROADMAP §3" in str(e.value)
        device = "meta"
    model = Transformer(cfg, device=device, dtype=torch.float32, seed=None,
                        layout=layout, ctx=ctx)
    specs = dict(_jax_flat(T.build_param_specs(jax_smoke(arch), jctx, layout)))
    pspecs = dict(_jax_flat(T.param_pspecs(jax_smoke(arch), jctx, layout)))
    shapes, axes = padded_shapes(cfg, ctx, layout), param_axes(cfg, layout, ctx)
    params = dict(model.named_parameters())
    assert set(shapes) == set(specs) == set(params)
    for name, spec in specs.items():
        assert shapes[name] == spec.shape, name
        assert axes[name] == spec.axes, name
        assert ctx.spec(*axes[name]) == tuple(pspecs[name]), name
        assert tuple(params[name].shape) == shard_shape(spec.shape, spec.axes, ctx), name
