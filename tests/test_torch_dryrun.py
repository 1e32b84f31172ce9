"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.specs``,
``analysis.counter``) against the reference's (``repro.launch.dryrun``,
``launch.specs``, ``analysis.hlo``).

The reference lowers and compiles in one subprocess on 8 host CPU devices
(``XLA_FLAGS`` set before ``import jax``, meshes with
``axis_types=(AxisType.Auto,)*n``, as ``tests/test_torch_parallel.py``
runs it) and writes ``analyze_compiled``'s counts and its analytic
roofline terms to a JSON file. Cases:

  * ``SHAPES`` and ``cells()`` equal the reference's; ``build_ctx`` gives
    the same rules for every cell on both production meshes, long_500k's
    override included;
  * the counter is exact on a matmul chain and on a loop of layers, folded
    or not, forward and backward (``tests/test_analysis.py``'s cases);
  * the counted FLOPs of one smoke config per family (dense, MoE with MLA,
    hybrid, ssm, vlm) x {train, prefill, decode} against the reference's
    ``analyze_compiled`` flops (both printed), first on one device, then on
    a (2,4) mesh. Four differences of design are added to the port's count
    by formula (``_design_gap``): the reference's jnp prefill attention
    multiplies every (query, key) pair of its chunks, K1 the causal ones;
    its prefill computes the logits of every position, the port's the last
    one's; its hybrid and ssm prefill run the stack a second time to
    harvest the states (``_harvest_mamba_states``), the port keeps them
    from its one pass; its loss takes the label's logit by a product with
    a one-hot (2 B S V), the port's by a gather. On one device every cell
    then lies within ``ONE_DEVICE_RTOL``, and all but two agree exactly:
    hybrid and ssm train, whose forward counts agree exactly and whose
    backward differ where the reference's multi-operand einsums of the
    Mamba2 chunk and the xLSTM step transpose into other products than
    the port's autograd runs through its pairwise ones. On the (2,4) mesh
    dense and vlm prefill and decode agree exactly; the
    other cells' ratios (``MESH_RATIO``, held within ``FLOPS_RTOL``) are
    those of the two partitions of the same count, since one device
    agrees: the port's train layout computes the k and v projections of
    the true kv heads whole on every "model" rank, which GSPMD splits; the
    port runs the xLSTM recurrences whole on every rank, which GSPMD
    splits over heads; GSPMD runs parts of the Mamba2 decode and the
    reference's harvest pass on the whole batch on every rank (so its
    harvest pass costs more than the port's main pass that the formula
    counts in its place); MLA and the MoE dispatch are split differently;
  * one smoke cell per §Perf lever on the (2,4) mesh against the
    reference's ``analyze_compiled`` with the same ``opts`` (``LEVER_CELLS``;
    exact, or at ``LEVER_RATIO`` within ``FLOPS_RTOL`` for the stated
    reasons; both packages' wire bytes by kind printed), and each lever's
    count against the port's own baseline of the cell: ``serve_2d_tp``
    gathers no weight at decode, ``moe_ff_shard`` fewer, ``seq_shard_decode``
    runs K2's split half, ``seq_parallel_norm`` trades all-reduce wire for
    reduce-scatters and gathers, ``train_kv_2d`` cuts the FLOPs, an int8
    cache the bytes, and ``decode_unroll`` moves nothing;
  * the analytic roofline terms equal the reference's given the same
    counts;
  * a ``psum`` of a known tensor books payload p and wire 2p(n-1)/n;
  * four full-width production cells trace on meta within ``TRACE_CAP_S``;
  * the grid's CLI writes a file per cell, counts a lever's cell
    (``--opts``) and records a refusal that remains (MLA under
    ``seq_shard_decode``) as the cell's error.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.specs import build_ctx as jax_build_ctx
from repro_torch.analysis.counter import OpCounter
from repro_torch.analysis.scopes import Steps
from repro_torch.configs import registry as treg
from repro_torch.configs.registry import ShapeSpec, get_smoke_config
from repro_torch.kernels.flash_attention.ops import causal_pairs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_ctx
from repro_torch.parallel.sharding import AbstractMesh, ParallelContext

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# every cell on one device (the module docstring)
ONE_DEVICE_RTOL = 0.025
FLOPS_RTOL = 0.02
# port / reference FLOPs on the (2,4) mesh after ``_design_gap``, where the
# two partition the step differently (the module docstring); the other
# cells agree exactly
MESH_RATIO = {
    "dense-train": 1.1914, "vlm-train": 1.1914, "moe-mla-train": 1.0615,
    "hybrid-train": 1.0438, "ssm-train": 1.3761,
    "moe-mla-prefill": 1.0752, "hybrid-prefill": 0.9372, "ssm-prefill": 1.0295,
    "moe-mla-decode": 1.0233, "hybrid-decode": 1.1586, "ssm-decode": 1.4299,
}
# one smoke cell per §Perf lever on the (2,4) mesh: (arch, kind, opts)
LEVER_CELLS = {
    "serve_2d_tp": ("llama3.2-3b", "decode", {"serve_2d_tp": True}),
    "moe_ff_shard": ("phi3.5-moe-42b-a6.6b", "decode", {"moe_ff_shard": True}),
    "seq_shard_decode": ("llama3.2-3b", "decode", {"seq_shard_decode": True}),
    "seq_parallel_norm": ("llama3.2-3b", "prefill", {"seq_parallel_norm": True}),
    "train_kv_2d": ("llama3.2-3b", "train", {"train_kv_2d": True}),
    "decode_unroll": ("llama3.2-3b", "decode", {"decode_unroll": True}),
    "kv_cache_dtype": ("llama3.2-3b", "decode", {"kv_cache_dtype": "int8"}),
}
# port / reference FLOPs of a lever cell after ``_design_gap``, where the
# two differ (the module docstring); the others agree exactly
LEVER_RATIO = {
    # the reference runs its tied head on both "data" ranks' rows, which
    # its act_d layout leaves gathered: 2 B d V / tp more
    "serve_2d_tp": 0.875,
    # the reference's lever multiplies only its own tokens by its d_ff
    # slice (its fault, ROADMAP §3); the port every "data" rank's tokens,
    # the baseline's function
    "moe_ff_shard": 1.9233,
    # the port computes the true kv heads' k and v whole on every "model"
    # rank, which GSPMD splits
    "seq_shard_decode": 1.2308,
    # the port contracts a d/tp block of the kv products on each rank, its
    # own rows only; the reference's count rises under the lever (its
    # baseline's is the port's baseline / 1.1914)
    "train_kv_2d": 0.8801,
}
TRACE_CAP_S = 120.0
MESH, ONE = (2, 4), (1, 1)
# smoke shapes of the three kinds: batches divide the (2,4) mesh's "data"
SMOKE_SHAPES = {"train": ShapeSpec("train_s", 32, 4, "train"),
                "prefill": ShapeSpec("prefill_s", 32, 4, "prefill"),
                "decode": ShapeSpec("decode_s", 64, 4, "decode")}
FAMILIES = {"dense": "llama3.2-3b", "moe-mla": "deepseek-r1-671b",
            "hybrid": "zamba2-2.7b", "ssm": "xlstm-350m", "vlm": "internvl2-76b"}
PRODUCTION = [("llama3-405b", "decode_32k"), ("kimi-k2-1t-a32b", "train_4k"),
              ("zamba2-2.7b", "long_500k"), ("xlstm-350m", "prefill_32k")]

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    jax.devices()
    from repro.analysis.hlo import analyze_compiled
    from repro.configs.registry import ShapeSpec, get_config, get_smoke_config
    from repro.launch.dryrun import roofline_terms
    from repro.launch.specs import build_ctx, input_specs
    from repro.models import transformer as T
    from repro.train import optimizer as opt_lib
    from repro.train.train_step import (make_decode_step, make_prefill_step,
                                        make_train_step)

    spec = json.load(open(sys.argv[1]))
    out = {"flops": {}, "wire": {}, "roofline": {}}
    for mesh_shape, cell, (arch, shp), opts in spec["cells"]:
        mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        cfg = get_smoke_config(arch)
        shape = ShapeSpec(*shp)
        ctx = build_ctx(mesh, False, cfg, shape, opts)
        mode = "train" if shape.kind == "train" else "serve"
        aparams = T.abstract_params(cfg, ctx, mode=mode, dtype=jnp.bfloat16)
        psh = T.param_shardings(cfg, ctx, mode=mode)
        sp = input_specs(cfg, shape, ctx)
        if shape.kind == "train":
            ocfg = opt_lib.AdamWConfig()
            aopt = opt_lib.abstract_opt_state(aparams, ocfg)
            osh = opt_lib.opt_state_shardings(psh, mesh)
            lowered = jax.jit(make_train_step(cfg, ctx, ocfg),
                              in_shardings=(psh, osh, sp["shardings"])).lower(
                aparams, aopt, sp["batch"])
        elif shape.kind == "prefill":
            args = [aparams, sp["batch"]["tokens"]]
            in_sh = [psh, sp["shardings"]["tokens"]]
            if "prefix_embeds" in sp["batch"]:
                args.append(sp["batch"]["prefix_embeds"])
                in_sh.append(sp["shardings"]["prefix_embeds"])
            lowered = jax.jit(make_prefill_step(cfg, ctx, max_len=shape.seq_len),
                              in_shardings=tuple(in_sh)).lower(*args)
        else:
            lowered = jax.jit(make_decode_step(cfg, ctx), in_shardings=(
                psh, sp["state_shardings"], sp["shardings"]["tokens"])).lower(
                aparams, sp["state"], sp["batch"]["tokens"])
        cost = analyze_compiled(lowered.compile(), mesh.size)
        key = f"{cell}@{mesh_shape[0]}x{mesh_shape[1]}"
        out["flops"][key] = cost["flops"]
        out["wire"][key] = cost["collective_wire_bytes"]
    for name, (arch, shp, res) in spec["roofline"].items():
        out["roofline"][name] = roofline_terms(dict(res), get_config(arch), ShapeSpec(*shp))
    json.dump(out, open(sys.argv[2], "w"))
""")


def _lever_cell(lever):
    arch, kind, _ = LEVER_CELLS[lever]
    return f"{arch}-{kind}+{lever}"


def _smoke_cells():
    return {f"{fam}-{kind}": (arch, dataclasses.astuple(shape))
            for fam, arch in FAMILIES.items() for kind, shape in SMOKE_SHAPES.items()}


def _synthetic_res(arch, shape_name):
    """Counts a cell's roofline reads, made up and the same for both sides."""
    rng = np.random.default_rng(len(arch) + len(shape_name))
    return {"flops": float(rng.uniform(1e12, 1e15)),
            "hbm_bytes": float(rng.uniform(1e9, 1e12)),
            "collective_wire_total": float(rng.uniform(1e8, 1e11)),
            "collective_payload_total": float(rng.uniform(1e8, 1e10)),
            "flash_scoped_bytes": float(rng.uniform(0, 1e8)),
            "n_devices": 256}


ROOFLINE_CELLS = {f"{a}-{s}": (a, s) for a, s, skip in treg.cells() if skip is None}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    spec = {"cells": [(m, cell, v, {}) for m in (MESH, ONE)
                      for cell, v in _smoke_cells().items()]
            + [(MESH, _lever_cell(lever), (arch, dataclasses.astuple(SMOKE_SHAPES[kind])),
                opts) for lever, (arch, kind, opts) in LEVER_CELLS.items()],
            "roofline": {k: (a, dataclasses.astuple(treg.SHAPES[s]), _synthetic_res(a, s))
                         for k, (a, s) in ROOFLINE_CELLS.items()}}
    (d / "spec.json").write_text(json.dumps(spec))
    script = d / "ref.py"
    script.write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(script), str(d / "spec.json"),
                    str(d / "out.json")], env=env, check=True, timeout=900)
    return json.loads((d / "out.json").read_text())


# ------------------------------------------------------------ registry, ctx
def test_shapes_and_cells_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in treg.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jreg.SHAPES.items()}
    assert list(treg.cells(include_skipped=True)) == list(jreg.cells(include_skipped=True))
    assert sum(1 for *_, skip in treg.cells(include_skipped=True) if skip) == 7
    assert sum(1 for _ in treg.cells()) == 33


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_build_ctx_rules_equal_the_reference(multi):
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    jmesh = jax.sharding.AbstractMesh(shape, names)
    tmesh = make_production_mesh(multi_pod=multi)
    assert tmesh.shape == shape and tmesh.mesh_dim_names == names
    for arch, shape_name, _ in treg.cells():
        cfg, sh = treg.get_config(arch), treg.SHAPES[shape_name]
        want = jax_build_ctx(jmesh, multi, jreg.get_config(arch), jreg.SHAPES[shape_name])
        got = build_ctx(tmesh, multi, cfg, sh)
        assert got.rules() == want.rules(), (arch, shape_name)
        assert (got.batch_axes, got.remat, got.fsdp_axis) == \
            (want.batch_axes, want.remat, want.fsdp_axis)
        if shape_name == "long_500k":
            assert got.rules()["cache_seq"] == "data" and got.rules()["batch"] is None


# ------------------------------------------------------------ the counter
def test_counter_exact_on_a_matmul_chain():
    a = torch.empty(16, 64, device="meta")
    w1 = torch.empty(64, 32, device="meta")
    w2 = torch.empty(32, 8, device="meta")
    with OpCounter() as c:
        y = torch.tanh(a @ w1) @ w2
    assert c.flops == 2 * 16 * 64 * 32 + 2 * 16 * 32 * 8
    # strict bytes: each product's operands and result at 2 bytes a float
    assert c.hbm_bytes == 2 * (16 * 64 + 64 * 32 + 16 * 32 + 16 * 32 + 32 * 8 + 16 * 8)
    assert y.shape == (16, 8)


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unrolled"])
def test_counter_multiplies_a_looped_body(fold):
    """A scan of L layers and a nested scan (G groups of P): forward FLOPs
    L * 2NDD, and with the backward three times that."""
    L, N, D = 6, 16, 64
    x = torch.empty(N, D, device="meta", requires_grad=True)
    w = torch.empty(L, D, D, device="meta", requires_grad=True)
    with OpCounter(fold_loops=fold) as c:
        h, ws = x, w.unbind(0)
        for i in Steps(L):
            h = torch.tanh(h @ ws[i])
    assert c.flops == L * 2 * N * D * D
    with OpCounter(fold_loops=fold) as c:
        h, ws = x, w.unbind(0)
        for i in Steps(L):
            h = torch.tanh(h @ ws[i])
        h.sum().backward()
    assert c.flops == 3 * L * 2 * N * D * D
    G, P = 3, 4
    wg = torch.empty(G, P, D, D, device="meta")
    with OpCounter(fold_loops=fold) as c:
        h = x.detach()
        for g in Steps(G):
            for p in Steps(P):
                h = h @ wg[g, p]
    assert c.flops == G * P * 2 * N * D * D


def test_psum_books_payload_and_ring_wire():
    n = 4
    ctx = ParallelContext(mesh=AbstractMesh((n, 2), ("data", "model")))
    x = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")
    p = 32 * 48 * 2
    with OpCounter() as c:
        y = ctx.comm.psum(x, "data")
    assert y.shape == x.shape
    assert c.coll_payload["all-reduce"] == p
    assert c.coll_wire["all-reduce"] == 2 * p * (n - 1) / n
    assert c.coll_count["all-reduce"] == 1
    assert ctx.comm.stats["all-reduce"]["wire"] == 2 * p * (n - 1) / n


# ------------------------------------------------------------ vs reference
def _attention_gap(cfg, shape, mesh):
    """The reference's prefill attention FLOPs less K1's, per device: the
    reference multiplies every (query, key) pair of its chunks, K1 the
    causal (windowed) ones."""
    if shape.kind != "prefill" or not cfg.n_attention_layers or cfg.attention == "mla":
        return 0.0
    hp = -(-cfg.n_heads // mesh[1])
    B = shape.global_batch // mesh[0]
    S, D = shape.seq_len, cfg.resolved_head_dim
    window = cfg.swa_window if cfg.attention == "swa" else 0
    return 4.0 * D * B * hp * (S * S - causal_pairs(S, S, window)) * cfg.n_attention_layers


def _design_gap(cfg, shape, port_flops, mesh):
    """The reference's FLOPs less the port's where the two differ by design
    (the module docstring), per device."""
    B, S = shape.global_batch // mesh[0], shape.seq_len
    if shape.kind == "train":                # the label logit as a one-hot product
        return 2.0 * B * S * cfg.vocab / mesh[1]
    if shape.kind != "prefill":
        return 0.0
    logits = 2.0 * B * cfg.d_model * cfg.vocab / mesh[1]       # one position's
    gap = _attention_gap(cfg, shape, mesh) + (S - 1) * logits
    if cfg.family in ("hybrid", "ssm"):                          # the harvest pass
        gap += port_flops - logits + _attention_gap(cfg, shape, mesh)
    return gap


def _ratio(reference, cell, mesh):
    arch, shp = _smoke_cells()[cell]
    cfg, shape = get_smoke_config(arch), ShapeSpec(*shp)
    res = dryrun.count_step(cfg, shape, None if mesh == ONE else
                            AbstractMesh(mesh, ("data", "model")), False)
    want = reference["flops"][f"{cell}@{mesh[0]}x{mesh[1]}"]
    gap = _design_gap(cfg, shape, res["flops"], mesh)
    ratio = (res["flops"] + gap) / want
    print(f"{cell} on {mesh}: port {res['flops']:.6e} + design gap {gap:.6e}, "
          f"reference {want:.6e}, ratio {ratio:.6f}")
    return ratio


@pytest.mark.parametrize("cell", sorted(_smoke_cells()))
def test_counted_flops_match_the_reference_on_one_device(reference, cell):
    """No partitioning on either side: every cell within ONE_DEVICE_RTOL."""
    assert _ratio(reference, cell, ONE) == pytest.approx(1.0, rel=ONE_DEVICE_RTOL)


@pytest.mark.parametrize("cell", sorted(_smoke_cells()))
def test_counted_flops_match_the_reference(reference, cell):
    """On the (2,4) mesh: exact where the two partition alike, else the
    ratio of the partitions (``MESH_RATIO``) within FLOPS_RTOL."""
    assert _ratio(reference, cell, MESH) == pytest.approx(
        MESH_RATIO.get(cell, 1.0), rel=FLOPS_RTOL if cell in MESH_RATIO else 1e-9)


def _lever_counts(lever, with_lever=True):
    arch, kind, opts = LEVER_CELLS[lever]
    return dryrun.count_step(get_smoke_config(arch), SMOKE_SHAPES[kind],
                             AbstractMesh(MESH, ("data", "model")), False,
                             opts if with_lever else None)


@pytest.mark.parametrize("lever", sorted(LEVER_CELLS))
def test_lever_cell_flops_match_the_reference(reference, lever):
    """The lever's smoke cell on the (2,4) mesh against the reference's
    ``analyze_compiled`` with the same ``opts``: exact where the two
    partition alike, else ``LEVER_RATIO`` within FLOPS_RTOL; both
    packages' wire bytes by kind printed."""
    arch, kind, _ = LEVER_CELLS[lever]
    cfg, shape = get_smoke_config(arch), SMOKE_SHAPES[kind]
    res = _lever_counts(lever)
    key = f"{_lever_cell(lever)}@{MESH[0]}x{MESH[1]}"
    want = reference["flops"][key]
    gap = _design_gap(cfg, shape, res["flops"], MESH)
    ratio = (res["flops"] + gap) / want
    # the reference's own baseline of the cell, where the smoke grid has it
    base = {f"{fam}-{kind}@{MESH[0]}x{MESH[1]}" for fam, a in FAMILIES.items()
            if a == arch}
    base_ref = {k: (reference["flops"][k], reference["wire"][k]) for k in base}
    print(f"{lever}: port {res['flops']:.6e} + design gap {gap:.6e}, reference "
          f"{want:.6e}, ratio {ratio:.6f}; wire by kind port "
          f"{res['collective_wire_bytes']}, reference {reference['wire'][key]}; "
          f"the reference's baseline (flops, wire) {base_ref}")
    assert ratio == pytest.approx(LEVER_RATIO.get(lever, 1.0),
                                  rel=FLOPS_RTOL if lever in LEVER_RATIO else 1e-9)


@pytest.mark.parametrize("lever", sorted(LEVER_CELLS))
def test_lever_moves_its_cell_as_designed(lever):
    """Each lever's count against the port's own baseline of the cell."""
    got, base = _lever_counts(lever), _lever_counts(lever, with_lever=False)
    wire, base_wire = got["collective_wire_bytes"], base["collective_wire_bytes"]
    print(f"{lever}: flops {base['flops']:.6e} -> {got['flops']:.6e}, hbm "
          f"{base['hbm_bytes']:.6e} -> {got['hbm_bytes']:.6e}, wire {base_wire} -> "
          f"{wire}, weight gathers {base['collective_weight_wire']:.6e} -> "
          f"{got['collective_weight_wire']:.6e}")
    if lever == "serve_2d_tp":
        # no weight moves at decode: the activations' gathers and the
        # partial sums' reduce-scatters instead
        assert got["collective_weight_wire"] == 0 < base["collective_weight_wire"]
        assert wire["reduce-scatter"] > 0
    elif lever == "moe_ff_shard":
        # replicated dispatch (2 tokens a "data" rank, tp 4): the experts'
        # d_ff shards stay put, their partial sums reduce-scattered
        assert got["collective_weight_wire"] < base["collective_weight_wire"]
        assert wire["reduce-scatter"] > 0
    elif lever == "seq_shard_decode":
        assert got["flops_by_op"]["paged_attention_partials"] > 0
        assert "paged_attention" not in got["flops_by_op"]
    elif lever == "seq_parallel_norm":
        # the block outputs' all-reduces become reduce-scatters and gathers
        assert wire["reduce-scatter"] > 0
        assert wire["all-reduce"] < base_wire["all-reduce"]
    elif lever == "train_kv_2d":
        assert got["flops"] < base["flops"]
    elif lever == "kv_cache_dtype":
        # an int8 pool: half the cache bytes of bf16
        assert got["hbm_bytes"] < base["hbm_bytes"]
    else:                                   # decode_unroll: nothing moves
        for key in ("flops", "hbm_bytes", "collective_wire_total"):
            assert got[key] == base[key], key


ANALYTIC = ("model_flops_per_dev", "must_bytes_per_dev", "useful_flop_ratio",
            "memory_efficiency", "hbm_bytes_kernel_adj")


def test_analytic_roofline_terms_equal_the_reference(reference):
    for name, (arch, shape_name) in ROOFLINE_CELLS.items():
        res = _synthetic_res(arch, shape_name)
        got = dryrun.roofline_terms(dict(res), treg.get_config(arch),
                                    treg.SHAPES[shape_name])
        want = reference["roofline"][name]
        for key in ANALYTIC:
            assert got[key] == pytest.approx(want[key], rel=1e-12), (name, key)
        assert got["constants"]["hardware"] == "h100-sxm"


# ------------------------------------------------------------ production
@pytest.mark.parametrize("arch,shape_name", PRODUCTION)
def test_production_cell_traces_on_meta(arch, shape_name):
    t0 = time.perf_counter()
    res = dryrun.count_cell(arch, shape_name, "single")
    took = time.perf_counter() - t0
    print(f"{arch} {shape_name}: {took:.2f} s, flops {res['flops']:.4e}, "
          f"hbm {res['hbm_bytes']:.4e}, wire {res['collective_wire_total']:.4e}, "
          f"bound {res['roofline']['bottleneck']}")
    assert took < TRACE_CAP_S
    assert res["n_devices"] == 256 and res["mesh"] == "16x16"
    assert res["flops"] > 0 and res["hbm_bytes"] > 0 and res["hbm_bytes_eager"] > 0
    assert res["collective_wire_total"] > 0
    assert res["memory"]["argument_bytes"] > 0
    assert res["roofline"]["step_time_bound_s"] > 0
    if shape_name == "long_500k":
        # the cache's sequence cut over "data": the partials gathered once a
        # shared-block invocation
        assert res["flops_by_op"]["paged_attention_partials"] > 0
        assert res["collective_counts"]["all-gather"] >= 9


def test_cli_writes_a_file_per_cell_and_records_refusals(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(tmp_path)]
    subprocess.run(base + ["--arch", "xlstm-350m", "--shape", "long_500k",
                           "--mesh", "both"], env=env, check=True, timeout=300)
    for mesh in ("single", "multi"):
        res = json.loads((tmp_path / f"xlstm-350m__long_500k__{mesh}__baseline.json")
                         .read_text())
        for key in ("flops", "hbm_bytes", "hbm_bytes_eager", "collective_payload_bytes",
                    "collective_wire_bytes", "collective_counts", "memory", "roofline"):
            assert key in res
    subprocess.run(base + ["--arch", "llama3.2-3b", "--shape", "decode_32k", "--mesh",
                           "single", "--tag", "lever", "--opts",
                           '{"serve_2d_tp": true}'], env=env, check=True, timeout=300)
    res = json.loads((tmp_path / "llama3.2-3b__decode_32k__single__lever.json").read_text())
    assert "error" not in res and res["opts"] == {"serve_2d_tp": "True"}
    assert res["roofline"]["step_time_bound_s"] > 0
    # a refusal that remains: MLA under a sequence-cut decode cache
    subprocess.run(base + ["--arch", "deepseek-r1-671b", "--shape", "decode_32k",
                           "--mesh", "single", "--tag", "lever", "--opts",
                           '{"seq_shard_decode": true}'], env=env, check=True, timeout=300)
    res = json.loads((tmp_path / "deepseek-r1-671b__decode_32k__single__lever.json")
                     .read_text())
    assert "NotImplementedError" in res["error"] and "ROADMAP §1" in res["error"]
