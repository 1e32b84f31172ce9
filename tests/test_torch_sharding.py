"""The port's sharding rules and layouts (``repro_torch.parallel.sharding``,
``repro_torch.models.transformer``'s padded shapes and rank shards)
against ``repro.parallel.sharding`` and the reference's serve-mode
``build_param_specs``/``param_pspecs``, with no process group: meshes are
``AbstractMesh``es on both sides.

Head padding equals the reference's over the (heads, kv, tp) range that
``tests/test_sharding.py`` draws; ``rules()`` and ``spec()`` are equal as
tuples of axis names, for the defaults and for each §Perf lever; and for
every served dense, vlm, audio and MoE config at tp 2, 4, 8 and 16 (with
"data" 1 and 2), the port's padded shapes and logical axes are the
reference's, and its rank shards tile them.
"""
import numpy as np
import pytest

pytest.importorskip(
    "hypothesis", reason="property-based tests need the 'test' extra")
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.parallel import sharding as ref  # noqa: E402
from repro_torch.configs.registry import ALL_MODELS, get_config  # noqa: E402
from repro_torch.models.transformer import (padded_shapes,  # noqa: E402
                                            param_axes)
from repro_torch.parallel import sharding as port  # noqa: E402

SERVED = sorted(a for a, c in ALL_MODELS.items()
                if c.family in ("dense", "vlm", "audio", "moe"))
LEVERS = [None, "fsdp_none", "pod", *port.PERF_LEVERS]


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 160), st.integers(0, 6), st.sampled_from([1, 2, 4, 8, 16]))
def test_head_padding_equals_reference(h, kv_div_pow, tp):
    divs = [d for d in range(1, h + 1) if h % d == 0]
    kv = divs[min(kv_div_pow, len(divs) - 1)]
    hp, kvp = port.padded_heads(h, kv, tp)
    assert (hp, kvp) == ref.padded_heads(h, kv, tp)
    np.testing.assert_array_equal(port.q_to_orig(hp, kvp, h, kv),
                                  ref.q_to_orig(hp, kvp, h, kv))
    np.testing.assert_array_equal(port.kv_to_orig(kvp, h, kv),
                                  ref.kv_to_orig(kvp, h, kv))


def _contexts(lever):
    """The same context on both sides: the defaults, FSDP off, a pod axis,
    or one lever set."""
    kw = {}
    if lever == "fsdp_none":
        kw["fsdp_axis"] = None
    elif lever == "pod":
        kw["batch_axes"] = ("pod", "data")
    elif lever is not None:
        kw[lever] = True
    return ref.ParallelContext(mesh=None, **kw), port.ParallelContext(mesh=None, **kw)


@pytest.mark.parametrize("lever", LEVERS, ids=str)
def test_rules_and_specs_equal_reference(lever):
    jctx, tctx = _contexts(lever)
    assert tctx.rules() == jctx.rules()
    names = sorted(ref.DEFAULT_RULES)
    assert tctx.spec(*names, None) == tuple(jctx.spec(*names, None))
    if lever in port.PERF_LEVERS:
        assert tctx.levers_set() == (lever,)


def test_rules_override_reaches_spec():
    jctx = ref.ParallelContext(mesh=None, rules_override={"cache_seq": "data"})
    tctx = port.ParallelContext(mesh=None, rules_override={"cache_seq": "data"})
    axes = ("layers", "cache_batch", "cache_seq", "cache_kv", None)
    assert tctx.spec(*axes) == tuple(jctx.spec(*axes)) == (None, "data", "data",
                                                           "model", None)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("tp", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", SERVED)
def test_rank_shards_tile_the_reference_padded_specs(arch, tp, data):
    shape, names = (data, tp), ("data", "model")
    jctx = ref.ParallelContext(mesh=JaxAbstractMesh(shape, names))
    tctx = port.ParallelContext(mesh=port.AbstractMesh(shape, names))
    jcfg, cfg = jax_config(arch), get_config(arch)
    specs = dict(_flat(T.build_param_specs(jcfg, jctx, "serve")))
    pspecs = dict(_flat(T.param_pspecs(jcfg, jctx, "serve")))
    shapes, axes = padded_shapes(cfg, tctx), param_axes(cfg)
    assert set(shapes) == set(specs)
    sizes = dict(zip(names, shape))
    for name, spec in specs.items():
        assert shapes[name] == spec.shape, name
        assert axes[name] == spec.axes, name
        entries = tctx.spec(*axes[name])
        assert entries == tuple(pspecs[name]), name
        local = port.shard_shape(shapes[name], axes[name], tctx)
        parts = [int(np.prod([sizes[a] for a in
                              ((e,) if isinstance(e, str) else e or ())]))
                 for e in entries]
        assert tuple(n * p for n, p in zip(local, parts)) == spec.shape, name
        # the ranks' slices cut each dimension into its parts, in order
        cuts = {port.shard_slices(spec.shape, axes[name], tctx,
                                  {"data": d, "model": m})
                for d in range(data) for m in range(tp)}
        assert len(cuts) == int(np.prod(parts)), name
        for dim, n in enumerate(spec.shape):
            starts = sorted({c[dim].start for c in cuts})
            assert starts == list(range(0, n, local[dim])), name


def test_shard_shape_refuses_a_dimension_that_does_not_divide():
    ctx = port.ParallelContext(mesh=port.AbstractMesh((1, 3), ("data", "model")))
    with pytest.raises(ValueError, match="does not divide"):
        port.shard_shape((64, 4, 16), ("embed", "heads", None), ctx)


def test_parallel_modules_import_no_jax_and_start_no_group():
    """The multi-device modules import neither JAX nor the JAX package, and
    importing them initialises no process group."""
    import os
    import subprocess
    import sys
    code = ("import sys\n"
            "import repro_torch.parallel.sharding, repro_torch.parallel.collectives, "
            "repro_torch.parallel.pipeline, repro_torch.launch.mesh\n"
            "import torch.distributed as dist\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(','.join(bad), dist.is_initialized())\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.path.abspath(src)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False"]


@pytest.mark.parametrize("case", ["zamba2-2.7b", "xlstm-350m", "train",
                                  *port.PERF_LEVERS, "remat"])
def test_the_sharded_model_refuses_what_is_not_ported(case):
    """Under a mesh every §Perf lever is taken: llama3.2-3b at full size
    passes ``check_shardable`` under it in the serve layout (the train
    layout for ``train_kv_2d`` and ``remat``) with the reference's
    padded shapes and specs. The hybrid and ssm families and the train
    layout take the baseline rules and an int8 kv cache, which a real
    device serves as meta counts it (``cache_dtype_of``)."""
    from repro_torch.models.transformer import cache_dtype_of, check_shardable
    import torch
    mesh = port.AbstractMesh((1, 2), ("data", "model"))
    arch = case if case in ALL_MODELS else "llama3.2-3b"
    layout = "train" if case in ("train", "train_kv_2d", "remat") else "serve"
    cfg = get_config(arch)
    if case in port.PERF_LEVERS or case == "remat":
        kw = {"remat": "full"} if case == "remat" else {case: True}
        ctx = port.ParallelContext(mesh=mesh, **kw)
        check_shardable(cfg, ctx, layout)
        jctx = ref.ParallelContext(mesh=JaxAbstractMesh((1, 2), ("data", "model")), **kw)
        specs = T.param_pspecs(jax_config(arch), jctx, layout)
        axes = param_axes(cfg, layout, ctx)
        for stack, leaves in specs.items():
            for leaf, pspec in (leaves.items() if isinstance(leaves, dict)
                                else [(None, leaves)]):
                name = stack if leaf is None else f"{stack}.{leaf}"
                assert ctx.spec(*axes[name]) == tuple(pspec), (case, name)
        return
    ctx = port.ParallelContext(mesh=mesh, kv_cache_dtype=torch.int8)
    assert cache_dtype_of(cfg, ctx, torch.bfloat16) == torch.int8
    check_shardable(cfg, ctx, layout)
    check_shardable(cfg, port.ParallelContext(mesh=mesh), layout)


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 4), (4, 4), (4, 16), (8, 3)])
def test_bubble_fraction_equals_reference(stages, micro):
    from repro.parallel.pipeline import bubble_fraction as ref_bubble
    from repro_torch.parallel.pipeline import bubble_fraction
    assert bubble_fraction(stages, micro) == ref_bubble(stages, micro)
