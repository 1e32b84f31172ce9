"""The port's multi-device path (``repro_torch.parallel``, the sharded
``Transformer``, ``moe_ffn`` and ``TorchRunner``) against the JAX
package's own mesh path, on gloo process groups of CPU ranks.

The reference runs in one subprocess on 8 host CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before ``import
jax``, as ``tests/test_distributed.py`` does), its meshes built with
``axis_types=(AxisType.Auto,)*n``; arrays pass through ``.npz`` files.
The port runs in ranks spawned by ``repro_torch.launch.mesh.run_ranks``,
one spawn per world size (2, 4 and 8), each rank writing its results to a
JSON file. All inputs come from numpy seeds or from the reference's
``init_params`` under its mesh. Cases, fp32:

  * ``moe_ffn``, split and replicated dispatch, on a (2,4) mesh with
    ``fsdp_axis`` None and "data", with no drops (capacity factor 8) and
    with drops and a shared expert (1.0): each rank's output rows within
    1e-5 of the reference's ``moe_ffn`` on the same mesh;
  * ``prefill`` and 4 greedy ``decode_step``s of the serve layout against
    the reference's mesh ``prefill``/``decode_step`` on the reference's
    parameters (each rank holding its shard of them): logits within 1e-4
    and the same greedy tokens, for llama3.2-3b on (1,2), (2,2) and (1,4)
    (kv tiled: 4 q / 2 kv heads give kvp 4), a 6 q / 2 kv variant on
    (1,4) (q padded to 8), qwen3-14b (qk-norm), h2o-danube (window 16 <
    the prompt's 20), phi3.5-moe, deepseek-r1 (MLA + MoE) and kimi-k2 on
    (1,2) and (2,2), musicgen and internvl2 with a prefix of 4 embeddings
    on (1,2); the seeded sharded init equals the tp=1 init's shards;
  * ``pipeline_forward`` on 4 stages against the reference (its test's
    shapes and scales): forward within 1e-6, and the gradient of each
    stage's weights within 1e-6 of its largest element (up to 8 here; the
    reference's own fp32 gradient is 3.3e-6 from a float64 one);
  * the sharded ``TorchRunner`` behind the engine on (1,2): greedy tokens
    equal the tp=1 port's, with and without forced preemption, for
    llama3.2-3b and deepseek-r1 (capacity factor raised to 64, so that no
    assignment drops at tp=1 or under split dispatch, whose capacity is a
    slice's); and on (2,2), "data" 2, llama3.2-3b preempting: each
    request's slot picks its data rank, tokens equal the tp=1 port's
    (``tests/test_torch_runner_mesh.py`` holds the same path to the
    reference's ``JaxRunner``).
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

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.bridge import from_jax_params
from repro_torch.parallel.sharding import ParallelContext, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MOE_ATOL = 1e-5
LOGIT_ATOL = 1e-4
PIPE_ATOL = 1e-6
DECODE_STEPS = 4
BATCH = 2
# name -> (arch, mesh (data, model), config overrides, prompt length, prefix)
PREFILL_CASES = {
    "llama-1x2": ("llama3.2-3b", (1, 2), {}, 12, 0),
    "llama-2x2": ("llama3.2-3b", (2, 2), {}, 12, 0),
    "llama-1x4-kv-tiled": ("llama3.2-3b", (1, 4), {}, 12, 0),
    "llama6q2kv-1x4-q-padded": ("llama3.2-3b", (1, 4), {"n_heads": 6}, 12, 0),
    "qwen3-1x2": ("qwen3-14b", (1, 2), {}, 12, 0),
    "qwen3-2x2": ("qwen3-14b", (2, 2), {}, 12, 0),
    "danube-1x2-window": ("h2o-danube-3-4b", (1, 2), {}, 20, 0),
    "phi-moe-1x2": ("phi3.5-moe-42b-a6.6b", (1, 2), {}, 12, 0),
    "phi-moe-2x2": ("phi3.5-moe-42b-a6.6b", (2, 2), {}, 12, 0),
    "r1-1x2": ("deepseek-r1-671b", (1, 2), {}, 12, 0),
    "r1-2x2": ("deepseek-r1-671b", (2, 2), {}, 12, 0),
    "kimi-1x2": ("kimi-k2-1t-a32b", (1, 2), {}, 12, 0),
    "kimi-2x2": ("kimi-k2-1t-a32b", (2, 2), {}, 12, 0),
    "musicgen-1x2-prefix": ("musicgen-medium", (1, 2), {}, 12, 4),
    "internvl2-1x2-prefix": ("internvl2-76b", (1, 2), {}, 12, 4),
}
# name -> (dispatch, fsdp axis, capacity factor, shared experts)
MOE_CASES = {f"{mode}-fsdp_{fsdp}-cf{cf}": (mode, fsdp, cf, shared)
             for mode in ("split", "replicated") for fsdp in (None, "data")
             for cf, shared in ((8.0, 0), (1.0, 1))}
RUNNER_CASES = [f"{arch}-{pool}" for arch in ("llama3.2-3b", "deepseek-r1-671b")
                for pool in ("ample", "preempting")]
MOE_SHAPE = dict(d=32, E=8, k=2, f=48, T=64)

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs.base import MoEConfig, ModelConfig
    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as T
    from repro.models.moe import moe_ffn
    from repro.parallel.pipeline import pipeline_forward
    from repro.parallel.sharding import ParallelContext

    spec = json.load(open(sys.argv[1]))
    out = sys.argv[2]

    def mesh_of(shape, names=("data", "model")):
        return jax.make_mesh(tuple(shape), names,
                             axis_types=(AxisType.Auto,) * len(shape))

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    for name, (arch, shape, over, S, n_prefix) in spec["prefill"].items():
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        mesh = mesh_of(shape)
        ctx = ParallelContext(mesh=mesh)
        params = T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="serve",
                               dtype=jnp.float32)
        params = jax.device_put(params, T.param_shardings(cfg, ctx, "serve"))
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab, (%(B)d, S)).astype(np.int32)
        prefix = (rng.standard_normal((%(B)d, n_prefix, cfg.d_model))
                  / np.sqrt(cfg.d_model)).astype(np.float32) if n_prefix else None
        pre = jax.jit(lambda p, t, pe: T.prefill(
            p, t, cfg, ctx, prefix_embeds=pe, max_len=S + n_prefix + %(steps)d,
            cache_dtype=jnp.float32))
        dec = jax.jit(lambda p, st, t: T.decode_step(p, st, t, cfg, ctx))
        tok = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
        last, state = pre(params, tok, None if prefix is None else jnp.asarray(prefix))
        logits, fed = [np.asarray(last)], []
        for _ in range(%(steps)d):
            nxt = np.argmax(logits[-1], axis=-1).astype(np.int32)
            fed.append(nxt)
            lg, state = dec(params, state, jnp.asarray(nxt[:, None]))
            logits.append(np.asarray(lg[:, 0]))
        arrays = dict(flat(params))
        arrays.update({"@tokens": tokens, "@logits": np.stack(logits),
                       "@fed": np.stack(fed)})
        if prefix is not None:
            arrays["@prefix"] = prefix
        np.savez(os.path.join(out, name + ".npz"), **arrays)

    m = spec["moe_shape"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m["T"], m["d"])).astype(np.float32)
    w = {"router": rng.standard_normal((m["d"], m["E"])) * 0.3,
         "we_gate": rng.standard_normal((m["E"], m["d"], m["f"])) * 0.1,
         "we_up": rng.standard_normal((m["E"], m["d"], m["f"])) * 0.1,
         "we_down": rng.standard_normal((m["E"], m["f"], m["d"])) * 0.1,
         "ws_gate": rng.standard_normal((m["d"], m["f"])) * 0.1,
         "ws_up": rng.standard_normal((m["d"], m["f"])) * 0.1,
         "ws_down": rng.standard_normal((m["f"], m["d"])) * 0.1}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    mesh = mesh_of((2, 4))
    for name, (mode, fsdp, cf, shared) in spec["moe"].items():
        cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=m["d"],
                          n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                          moe=MoEConfig(n_experts=m["E"], top_k=m["k"],
                                        d_ff_expert=m["f"], capacity_factor=cf,
                                        n_shared_experts=shared))
        ctx = ParallelContext(mesh=mesh, fsdp_axis=fsdp, moe_dispatch=mode)
        p = {k: jnp.asarray(v) for k, v in w.items()
             if shared or not k.startswith("ws_")}
        y = jax.jit(lambda x: moe_ffn(x, p, cfg, ctx, token_axes=None))(jnp.asarray(x))
        np.savez(os.path.join(out, "moe-" + name + ".npz"), x=x, y=np.asarray(y),
                 **{k: v for k, v in w.items()})

    rng = np.random.default_rng(3)
    W = (rng.standard_normal((4, 32, 32)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    mesh = mesh_of((4,), ("stage",))
    stage = lambda w, xm: jnp.tanh(xm @ w)
    y = pipeline_forward(stage, jnp.asarray(W), jnp.asarray(x), mesh=mesh, n_micro=4)
    g = jax.grad(lambda W: pipeline_forward(stage, W, jnp.asarray(x), mesh=mesh,
                                            n_micro=2).sum())(jnp.asarray(W))
    np.savez(os.path.join(out, "pipeline.npz"), W=W, x=x, y=np.asarray(y),
             g=np.asarray(g))
""" % {"B": BATCH, "steps": DECODE_STEPS})


def _smoke(arch, over):
    return dataclasses.replace(get_smoke_config(arch), **over)


def _write(out, rank, name, result):
    with open(os.path.join(out, f"{name}.rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _mesh(data, model):
    return make_test_mesh(data, model)


# ------------------------------------------------------------------ ranks
def _prefill_decode(rank, name, case, ref, out):
    """Serve-layout prefill and decode of this rank's shard against the
    reference's logits, on the reference's own greedy tokens."""
    arch, (data, model), over, S, n_prefix = case
    cfg = _smoke(arch, over)
    ctx = ParallelContext(mesh=_mesh(data, model))
    z = np.load(os.path.join(ref, name + ".npz"))
    params = {k: z[k] for k in z.files if not k.startswith("@")}
    nested = {}
    for k, v in params.items():
        node = nested
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    m = from_jax_params(nested, cfg, device="cpu", dtype=torch.float32, ctx=ctx)
    rows = slice(ctx.coords()["data"] * BATCH // data,
                 (ctx.coords()["data"] + 1) * BATCH // data)
    tokens = torch.from_numpy(z["@tokens"][rows].astype(np.int64))
    prefix = torch.from_numpy(z["@prefix"][rows]) if n_prefix else None
    want, fed = z["@logits"][:, rows], z["@fed"][:, rows]
    last, caches, _ = m.prefill(tokens, prefix)
    B, n = tokens.shape[0], S + n_prefix
    page = 4
    per = -(-(n + DECODE_STEPS) // page)
    pools = [torch.zeros(s) for s in m.pool_shapes(B * per, page)]
    tables = torch.arange(B * per, dtype=torch.int32).view(B, per)
    pos = torch.arange(n)
    for j, pool in enumerate(pools):
        for b in range(B):
            pool[:, tables[b, pos // page].long(), pos % page] = torch.stack(
                [c[j][b] for c in caches])
    got = [last]
    for i in range(DECODE_STEPS):
        got.append(m.decode_step(torch.from_numpy(fed[i].astype(np.int64)),
                                 torch.full((B,), n + i), pools, tables))
    got = torch.stack(got).numpy()
    _write(out, rank, name, dict(
        max_abs=float(np.abs(got - want).max()),
        tokens_equal=bool((got[:-1].argmax(-1) == fed).all()),
        finite=bool(np.isfinite(got).all()), shape=list(got.shape),
        want_shape=list(want.shape), kv_heads=m.n_kv, q_heads=m.n_q))


def _seeded_init(rank, name, arch, data, model, out):
    """The sharded seeded init holds the shards of the tp=1 seeded init
    (padded, tiled and cut by ``take_shard``)."""
    from repro_torch.models.transformer import Transformer, param_axes, take_shard
    cfg = _smoke(arch, {})
    ctx = ParallelContext(mesh=_mesh(data, model))
    one = dict(Transformer(cfg, device="cpu", dtype=torch.float32,
                           seed=5).named_parameters())
    sharded = Transformer(cfg, device="cpu", dtype=torch.float32, seed=5, ctx=ctx)
    axes, bad = param_axes(cfg), []
    for n, p in sharded.named_parameters():
        if axes[n][0] == "layers":
            want = torch.stack([take_shard(w, axes[n][1:], cfg, ctx, ctx.coords())
                                for w in one[n]])
        else:
            want = take_shard(one[n], axes[n], cfg, ctx, ctx.coords())
        if not torch.equal(want, p.data):
            bad.append(n)
    _write(out, rank, name, dict(mismatched=bad))


def _moe(rank, name, case, ref, out):
    from repro_torch.models.moe import moe_ffn
    from repro_torch.parallel.sharding import shard_slices
    mode, fsdp, cf, shared = case
    s = MOE_SHAPE
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=s["d"],
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                      moe=MoEConfig(n_experts=s["E"], top_k=s["k"],
                                    d_ff_expert=s["f"], capacity_factor=cf,
                                    n_shared_experts=shared))
    ctx = ParallelContext(mesh=_mesh(2, 4), fsdp_axis=fsdp, moe_dispatch=mode)
    z = np.load(os.path.join(ref, f"moe-{name}.npz"))
    axes = {"router": (None, None), "we_gate": ("expert", "expert_in", None),
            "we_up": ("expert", "expert_in", None),
            "we_down": ("expert", None, "expert_in"),
            "ws_gate": ("embed", None), "ws_up": ("embed", None),
            "ws_down": (None, "embed")}
    p = {k: torch.from_numpy(np.ascontiguousarray(
        z[k][shard_slices(z[k].shape, a, ctx, ctx.coords())]))
         for k, a in axes.items() if shared or not k.startswith("ws_")}
    d = ctx.coords()["data"]
    rows = slice(d * s["T"] // 2, (d + 1) * s["T"] // 2)
    y = moe_ffn(torch.from_numpy(z["x"][rows]), p, cfg, ctx)
    _write(out, rank, "moe-" + name, dict(
        max_abs=float(np.abs(y.numpy() - z["y"][rows]).max()),
        stats={k: v["calls"] for k, v in ctx.comm.stats.items()}))


def _pipeline(rank, ref, out):
    from repro_torch.parallel.pipeline import pipeline_forward
    z = np.load(os.path.join(ref, "pipeline.npz"))
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    w = torch.from_numpy(z["W"][rank]).requires_grad_(True)
    x = torch.from_numpy(z["x"])
    stage = lambda w, xm: torch.tanh(xm @ w)  # noqa: E731
    y = pipeline_forward(stage, w, x, mesh=mesh, n_micro=4)
    pipeline_forward(stage, w, x, mesh=mesh, n_micro=2).sum().backward()
    _write(out, rank, "pipeline", dict(
        fwd=float(np.abs(y.detach().numpy() - z["y"]).max()),
        grad=float(np.abs(w.grad.numpy() - z["g"][rank]).max()
                   / np.abs(z["g"][rank]).max())))


def _runner(rank, out):
    """Greedy tokens through the engine and the sharded runner on (1,2)
    against the tp=1 port, seeded alike."""
    from repro_torch.launch.serve import make_requests, serve_sharded
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models.transformer import Transformer
    ctx = ParallelContext(mesh=_mesh(1, 2))
    for case in RUNNER_CASES:
        arch, pool = case.rsplit("-", 1)
        cfg = get_smoke_config(arch)
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=64.0))
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


def _world2(rank, ref, out):
    for name, case in PREFILL_CASES.items():
        if case[1] == (1, 2):
            _prefill_decode(rank, name, case, ref, out)
    _seeded_init(rank, "init-r1-1x2", "deepseek-r1-671b", 1, 2, out)
    _runner(rank, out)


def _runner_data2(rank, out):
    """llama3.2-3b served on (2,2) behind the engine, preempting, against
    the tp=1 port: the slots, and so the requests, split over "data"."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import make_requests, serve_sharded
    from repro_torch.models.transformer import Transformer
    cfg = get_smoke_config("llama3.2-3b")
    requests = make_requests(cfg.vocab, 5, (10, 30), (12, 20), seed=4)
    engine = dict(n_pages=9, max_num_seqs=6, max_num_batched_tokens=512,
                  chunk_size=192, admission_mode="naive")
    eng, reqs = serve_sharded(cfg, requests, ParallelContext(mesh=_mesh(2, 2)),
                              device="cpu", dtype=torch.float32, seed=2, **engine)
    if eng is None:
        return
    one = InferenceEngine(cfg, EngineConfig(**engine), TorchRunner(
        Transformer(cfg, device="cpu", dtype=torch.float32, seed=2), device="cpu"),
        virtual_clock=False)
    ones = [one.submit(p, n) for p, n in requests]
    one.run()
    _write(out, rank, "runner-data2", dict(
        sharded=[r.output for r in reqs], tp1=[r.output for r in ones],
        preemptions=sum(r.n_preemptions for r in reqs), dp=eng.runner.dp))


def _world4(rank, ref, out):
    for name, case in PREFILL_CASES.items():
        if case[1] in ((2, 2), (1, 4)):
            _prefill_decode(rank, name, case, ref, out)
    _seeded_init(rank, "init-llama-1x4", "llama3.2-3b", 1, 4, out)
    _seeded_init(rank, "init-qwen3-2x2", "qwen3-14b", 2, 2, out)
    _pipeline(rank, ref, out)
    _runner_data2(rank, out)


def _world8(rank, ref, out):
    for name, case in MOE_CASES.items():
        _moe(rank, name, case, ref, out)


# ------------------------------------------------------------------ fixture
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    out = tmp_path_factory.mktemp("ranks")
    spec = ref / "spec.json"
    spec.write_text(json.dumps({"prefill": PREFILL_CASES, "moe": MOE_CASES,
                                "moe_shape": MOE_SHAPE}))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(spec), str(ref)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for world, fn in ((2, _world2), (4, _world4), (8, _world8)):
        run_ranks(fn, world, (str(ref), str(out)))
    got = {}
    for f in sorted(os.listdir(out)):
        name, rank = f[:-len(".json")].rsplit(".rank", 1)
        got.setdefault(name, {})[int(rank)] = json.loads((out / f).read_text())
    return got


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_ffn_matches_the_reference_mesh(results, name):
    ranks = results["moe-" + name]
    assert len(ranks) == 8
    for r in ranks.values():
        assert r["max_abs"] <= MOE_ATOL, ranks
    mode = MOE_CASES[name][0]
    used = "all_to_all" if mode == "split" else "all_reduce"
    assert all(used in r["stats"] for r in ranks.values())


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_and_decode_match_the_reference_mesh(results, name):
    data, model = PREFILL_CASES[name][1]
    ranks = results[name]
    assert len(ranks) == data * model
    for r in ranks.values():
        assert r["finite"] and r["shape"] == r["want_shape"], r
        assert r["max_abs"] <= LOGIT_ATOL, ranks
        assert r["tokens_equal"], ranks


def test_padded_layouts_tile_kv_and_pad_q(results):
    tiled = results["llama-1x4-kv-tiled"][0]
    padded = results["llama6q2kv-1x4-q-padded"][0]
    # 4 q / 2 kv at tp 4: kvp 4, one q and one kv head a rank;
    # 6 q / 2 kv: hp 8, kvp 4, two q slots and one kv head a rank
    assert (tiled["q_heads"], tiled["kv_heads"]) == (1, 1)
    assert (padded["q_heads"], padded["kv_heads"]) == (2, 1)


@pytest.mark.parametrize("name", ["init-r1-1x2", "init-llama-1x4", "init-qwen3-2x2"])
def test_seeded_init_is_the_tp1_model(results, name):
    for r in results[name].values():
        assert r["mismatched"] == []


def test_pipeline_forward_and_grad_match_the_reference(results):
    ranks = results["pipeline"]
    assert len(ranks) == 4
    for r in ranks.values():
        assert r["fwd"] <= PIPE_ATOL and r["grad"] <= PIPE_ATOL, ranks


@pytest.mark.parametrize("case", RUNNER_CASES)
def test_sharded_runner_tokens_equal_tp1(results, case):
    r = results["runner-" + case][0]
    assert r["finished"]
    assert r["sharded"] == r["tp1"]
    if case.endswith("preempting"):
        assert r["preemptions"] > 0


def test_runner_on_data2_equals_tp1(results):
    """The runner serves on "data" 2 (its leader alone writes the result):
    greedy tokens equal tp=1's through preemptions."""
    ranks = results["runner-data2"]
    assert list(ranks) == [0]
    r = ranks[0]
    assert r["dp"] == 2 and r["preemptions"] > 0
    assert r["sharded"] == r["tp1"]
