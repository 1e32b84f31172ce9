"""``TorchRunner`` behind the engine over "data" > 1 and under
``seq_shard_decode``, against the JAX engine on ``JaxRunner`` on the same
mesh, lever set and weights.

The reference runs in one subprocess on 8 host CPU devices (``XLA_FLAGS``
set before ``import jax``; meshes built with ``axis_types=(AxisType.Auto,)
* 2``): for each case its ``init_params`` under the case's mesh, its
``JaxRunner`` with ``SLOTS`` slots (a count no dimension of the smoke
models' decode state has, so ``JaxRunner._bmask`` finds the slot axis)
and its engine, greedy, to completion. The port loads the same parameters
(``from_jax_params(ctx=)``) in gloo CPU ranks spawned by
``repro_torch.launch.mesh.run_ranks`` (worlds 2 and 4) and serves the same
requests under the same ``EngineConfig``. Cases, fp32:

  * "data" > 1: llama3.2-3b and zamba2-2.7b on (2,1) and (2,2), with
    preemption (a 7-page pool) and without; prompts of two lengths;
  * the levers that act across "data": ``serve_2d_tp`` (llama on (2,2))
    and ``moe_ff_shard`` (phi3.5-moe on (2,2), replicated dispatch), the
    latter held to the reference's baseline, since the reference's lever
    is wrong on "data" > 1 (ROADMAP §3);
  * ``seq_shard_decode`` on (1,2): llama, zamba2 and deepseek-r1 (MLA),
    4-token pages, a rank's share of ``MAX_LEN`` passed by the longer
    sequences, on a pool smaller than the ranks' shares of every slot and
    on one that holds them;
  * deepseek-r1 on (2,1) against the port's tp=1 (the reference's runner
    raises there: ROADMAP §3), with an odd prompt length;
  * llama on (2,1) with requests that all land on data rank 0 (three
    requests for its three slots).

Every port case runs under the reference's bound ``max_len=MAX_LEN``
(``TorchRunner``'s per-rank page map): each rank's pool must hold the
reference's per-device cache shard (its k and v, or latents, as
``state_shardings`` cuts them) plus one pad page where the engine's pool
holds the share (``n_pages >= rows * share_blocks``), and ``n_pages`` plus
the pad page where it is smaller (the 7-page and 24-page pools). Without
``max_len`` each rank's pool holds ``n_pages`` plus the pad page, as
before. Only the leader is given ``max_len``: the followers size their
pools by the one it sends them.

The MoE models' capacity factor is raised to ``MOE_CF`` in both packages,
so that no assignment drops: the reference's decode runs all its slots,
the port's the running requests, and a drop would make a token depend on
its step's batch. The greedy tokens must be equal. The file takes about a
minute; keep it in one xdist worker (``--dist loadfile``).
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
from repro_torch.launch.serve import make_requests
from repro_torch.parallel.sharding import ParallelContext, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SLOTS = 6
MAX_LEN = 64
MOE_CF = 64.0
# pool -> (EngineConfig overrides, the requests' (isl, osl) ranges)
POOLS = {
    "ample": (dict(n_pages=64), ((9, 31), (8, 14))),
    "preempting": (dict(n_pages=7), ((9, 31), (8, 14))),
    # a rank's share of MAX_LEN's 16 pages of 4 tokens is 8 pages: 32
    # positions, which the longer sequences (up to 54 tokens) pass; 24
    # pages hold less than the ranks' shares of all SLOTS (48), so a rank's
    # pool is the engine's; kv-aware admission, since naive admission's
    # concurrent chunked prefills can exhaust a small pool and wait on
    # each other for good
    "split": (dict(n_pages=24, page_size=4, admission_mode="kv_aware"),
              ((20, 40), (8, 14))),
    # the same with a pool that holds every slot's share: a rank's pool is
    # the reference's cache shard
    "split-shares": (dict(n_pages=48, page_size=4, admission_mode="kv_aware"),
                     ((20, 40), (8, 14))),
}
ENGINE = dict(max_num_seqs=SLOTS, max_num_batched_tokens=512, chunk_size=16,
              admission_mode="naive")
N_REQUESTS = 4
# cases with another number of requests: a data rank's slots alone
N_OF = {"llama-2x1-one-data-rank": 3}
# name -> (arch, mesh (data, model), ParallelContext options, pool, the
#          reference run it is held to: under the "lever" or its "baseline")
CASES = {
    "llama-2x1-preempting": ("llama3.2-3b", (2, 1), {}, "preempting", "lever"),
    "llama-2x2-preempting": ("llama3.2-3b", (2, 2), {}, "preempting", "lever"),
    "zamba2-2x1-preempting": ("zamba2-2.7b", (2, 1), {}, "preempting", "lever"),
    "zamba2-2x2-ample": ("zamba2-2.7b", (2, 2), {}, "ample", "lever"),
    "llama-2x1-one-data-rank": ("llama3.2-3b", (2, 1), {}, "ample", "lever"),
    "serve_2d_tp-llama-2x2": ("llama3.2-3b", (2, 2), {"serve_2d_tp": True},
                              "preempting", "lever"),
    "moe_ff_shard-phi-2x2": ("phi3.5-moe-42b-a6.6b", (2, 2),
                             {"moe_ff_shard": True, "moe_dispatch": "replicated"},
                             "ample", "baseline"),
    "seq_shard_decode-llama-1x2": ("llama3.2-3b", (1, 2), {"seq_shard_decode": True},
                                   "split", "lever"),
    "seq_shard_decode-zamba2-1x2": ("zamba2-2.7b", (1, 2), {"seq_shard_decode": True},
                                    "split", "lever"),
    "seq_shard_decode-r1-1x2": ("deepseek-r1-671b", (1, 2), {"seq_shard_decode": True},
                                "split", "lever"),
    "seq_shard_decode-llama-1x2-shares": ("llama3.2-3b", (1, 2),
                                          {"seq_shard_decode": True},
                                          "split-shares", "lever"),
    "seq_shard_decode-zamba2-1x2-shares": ("zamba2-2.7b", (1, 2),
                                           {"seq_shard_decode": True},
                                           "split-shares", "lever"),
    "seq_shard_decode-r1-1x2-shares": ("deepseek-r1-671b", (1, 2),
                                       {"seq_shard_decode": True},
                                       "split-shares", "lever"),
}

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config
    from repro.core.engine import EngineConfig, InferenceEngine
    from repro.core.runner import JaxRunner
    from repro.launch.specs import state_shardings
    from repro.models import transformer as T
    from repro.parallel.sharding import ParallelContext

    spec = json.load(open(sys.argv[1]))
    out = sys.argv[2]

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    for name, (arch, shape, opts, pool, held) in spec["cases"].items():
        cfg = get_smoke_config(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=spec["moe_cf"]))
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ctx = ParallelContext(mesh=mesh, **opts)
        params = T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="serve",
                               dtype=jnp.float32)
        run = ctx if held == "lever" else ParallelContext(
            mesh=mesh, **{k: v for k, v in opts.items() if k == "moe_dispatch"})
        runner = JaxRunner(cfg, jax.device_put(params, T.param_shardings(cfg, run, "serve")),
                           run, max_slots=spec["slots"], max_len=spec["max_len"])
        eng = InferenceEngine(cfg, EngineConfig(**spec["engine"][name]), runner,
                              virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in spec["requests"][name]]
        eng.run(max_steps=2000)
        np.savez(os.path.join(out, name + ".npz"), **dict(flat(params)))
        # a device's shard of the cache's k and v (or latents), as the
        # decode state's shardings cut them
        cut = state_shardings(cfg, run)["caches"]
        shard = sum(int(np.prod(sh.shard_shape(a.shape))) * a.dtype.itemsize
                    for a, sh in zip(jax.tree_util.tree_leaves(runner.state["caches"]),
                                     jax.tree_util.tree_leaves(cut)))
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(dict(outputs=[r.output for r in reqs],
                           preemptions=sum(r.n_preemptions for r in reqs),
                           cache_shard_bytes=shard), f)
""")


def _cfg(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=MOE_CF))


def _requests(name):
    """The case's requests: prompts of two lengths in turn (each length is
    one compile of the reference's prefill), an odd one and an even one,
    but for an MoE model on "data" > 1, whose prompts take even lengths:
    the reference's MoE ``shard_map`` cuts a prefill's tokens over "data"
    (ROADMAP §3)."""
    arch, (data, _), _, pool, _ = CASES[name]
    (lo, hi), osl = POOLS[pool][1]
    cfg = get_smoke_config(arch)
    lens = (lo + lo % 2 + 1, hi - hi % 2)
    if cfg.moe is not None and data > 1:
        lens = (lens[0] + 1, lens[1])
    reqs = make_requests(cfg.vocab, N_OF.get(name, N_REQUESTS), (hi, hi), osl,
                         seed=len(name))
    return [(p[:lens[i % 2]], n) for i, (p, n) in enumerate(reqs)]


def _engine(name):
    return dict(ENGINE, **POOLS[CASES[name][3]][0])


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


# ------------------------------------------------------------------ ranks
def _serve_case(rank, name, ref, out):
    """The case's requests through the port's engine on ``TorchRunner``
    over the case's mesh, on the reference's parameters."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models.bridge import from_jax_params
    arch, mesh, opts, _, _ = CASES[name]
    cfg = _cfg(arch)
    ctx = ParallelContext(mesh=make_test_mesh(*mesh), **opts)
    z = np.load(os.path.join(ref, name + ".npz"))
    model = from_jax_params(_nest({k: z[k] for k in z.files}), cfg, device="cpu",
                            dtype=torch.float32, ctx=ctx)
    # rank 0 leads; the followers take its max_len with the engine's pool
    runner = TorchRunner(model, device="cpu", max_len=MAX_LEN if rank == 0 else None)
    engine = _engine(name)
    # the same rank's pools without max_len (bound alone: no collective)
    legacy = TorchRunner(model, device="cpu")
    legacy._bind(engine["n_pages"], engine.get("page_size", 16), SLOTS, None)
    if not runner.leads:
        runner.follow()
        _write(out, rank, name + ".pools", _pools(runner, legacy))
        return
    data_ranks = set()
    prefill = runner.prefill

    def tracked(req, chunk):
        tok = prefill(req, chunk)
        data_ranks.add(runner._slot_of[req.rid] // runner.rows)
        return tok

    runner.prefill = tracked
    try:
        eng = InferenceEngine(cfg, EngineConfig(**engine), runner, virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in _requests(name)]
        eng.run(max_steps=2000)
    finally:
        runner.close()
    _write(out, rank, name, dict(
        outputs=[r.output for r in reqs], preemptions=sum(r.n_preemptions for r in reqs),
        dp=runner.dp, sp=runner.sp, share=runner.share_blocks * eng.ecfg.page_size,
        longest=max(len(r.prompt) + len(r.output) for r in reqs),
        data_ranks=sorted(data_ranks)))
    _write(out, rank, name + ".pools", _pools(runner, legacy))


def _pools(runner, legacy):
    """A rank's pool bytes and pages (the pad page included), with and
    without max_len, and the geometry that sizes them."""
    def size(r):
        return dict(bytes=sum(t.numel() * t.element_size() for t in r.pools),
                    pages=r.pools[0].shape[1] if r.pools else 0)
    return dict(with_max_len=size(runner), without=size(legacy), rows=runner.rows,
                share_blocks=runner.share_blocks, pad=runner.pad_page is not None)


def _r1_data2(rank, out):
    """deepseek-r1 on (2,1) against the port's tp=1, seeded alike; an odd
    prompt among uneven ones, preempting."""
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import serve_sharded
    from repro_torch.models.transformer import Transformer
    cfg = _cfg("deepseek-r1-671b")
    requests = make_requests(cfg.vocab, N_REQUESTS, (9, 31), (8, 14), seed=11)
    engine = dict(ENGINE, n_pages=9)
    eng, reqs = serve_sharded(cfg, requests, ParallelContext(mesh=make_test_mesh(2, 1)),
                              device="cpu", dtype=torch.float32, seed=2, **engine)
    if eng is None:
        return
    one = InferenceEngine(cfg, EngineConfig(**engine), TorchRunner(
        Transformer(cfg, device="cpu", dtype=torch.float32, seed=2), device="cpu"),
        virtual_clock=False)
    ones = [one.submit(p, n) for p, n in requests]
    one.run()
    _write(out, rank, "r1-2x1-tp1", dict(
        sharded=[r.output for r in reqs], tp1=[r.output for r in ones],
        lens=[len(p) for p, _ in requests],
        preemptions=sum(r.n_preemptions for r in reqs)))


def _world2(rank, ref, out):
    for name, case in CASES.items():
        if case[1][0] * case[1][1] == 2:
            _serve_case(rank, name, ref, out)
    _r1_data2(rank, out)


def _world4(rank, ref, out):
    for name, case in CASES.items():
        if case[1] == (2, 2):
            _serve_case(rank, name, ref, out)


# ------------------------------------------------------------------ fixture
@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    out = tmp_path_factory.mktemp("ranks")
    spec = ref / "spec.json"
    spec.write_text(json.dumps({
        "cases": CASES, "slots": SLOTS, "max_len": MAX_LEN, "moe_cf": MOE_CF,
        "engine": {n: _engine(n) for n in CASES},
        "requests": {n: _requests(n) for n in CASES}}))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(spec), str(ref)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for world, fn in ((2, _world2), (4, _world4)):
        run_ranks(fn, world, (str(ref), str(out)))
    got = {}
    for f in sorted(os.listdir(out)):
        name, rank = f[:-len(".json")].rsplit(".rank", 1)
        got.setdefault(name, {})[int(rank)] = json.loads((out / f).read_text())
    want = {n: json.loads((ref / f"{n}.json").read_text()) for n in CASES}
    return got, want


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", sorted(CASES))
def test_runner_tokens_equal_the_reference_engine(results, name):
    """The leader (alone) returns the reference engine's greedy tokens,
    through the same preemptions."""
    got, want = results
    ranks = got[name]
    assert list(ranks) == [0]
    r, w = ranks[0], want[name]
    assert [len(t) for t in r["outputs"]] == [n for _, n in _requests(name)]
    assert r["outputs"] == w["outputs"]
    assert r["preemptions"] == w["preemptions"]
    data, model = CASES[name][1]
    assert r["dp"] == data
    if CASES[name][3] == "preempting":
        assert r["preemptions"] > 0
    if "seq_shard_decode" in CASES[name][2]:
        # the second rank's share is reached
        assert r["sp"] == model and r["longest"] > r["share"]
    if name in N_OF:
        assert r["data_ranks"] == [0]
    print(name, "preemptions", r["preemptions"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_the_reference_cache_shard(results, name):
    """Every rank's pool under max_len: the reference's per-device cache
    shard plus one pad page where the engine's pool holds the ranks' share
    of every slot, else the engine's pool plus the pad page; without
    max_len the engine's whole pool plus the pad page, as before."""
    got, want = results
    data, model = CASES[name][1]
    ranks = got[name + ".pools"]
    assert sorted(ranks) == list(range(data * model))
    n_pages = _engine(name)["n_pages"]
    for rank, p in ranks.items():
        pool, legacy = p["with_max_len"], p["without"]
        assert p["pad"] and legacy["pages"] == n_pages + 1
        assert legacy["bytes"] == pool["bytes"] // pool["pages"] * legacy["pages"]
        page_bytes = pool["bytes"] // pool["pages"]
        if n_pages >= p["rows"] * p["share_blocks"]:
            assert pool["bytes"] - page_bytes == want[name]["cache_shard_bytes"], rank
            assert pool["pages"] == p["rows"] * p["share_blocks"] + 1
        else:
            assert pool["pages"] == n_pages + 1
    print(name, "rank pool", ranks[0]["with_max_len"], "without max_len",
          ranks[0]["without"], "reference shard", want[name]["cache_shard_bytes"])


def test_r1_on_data2_equals_tp1(results):
    got, _ = results
    r = got["r1-2x1-tp1"][0]
    assert any(n % 2 for n in r["lens"]) and r["preemptions"] > 0
    assert r["sharded"] == r["tp1"]
