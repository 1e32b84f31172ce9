"""The reference's ``kv_cache_dtype`` lever on the port, against the JAX
package on the CPU: fp8 e4m3, int8, and a float cache of another width
than the model (bf16 under fp32).

* ``to_cache_dtype`` against ``jnp.astype`` over a grid (every e4m3 value
  and the ties between them, subnormals, +-448/464/500, int8's saturation
  and truncation, NaN and infinities): equal, bit for bit.
* K2's plain version against ``repro.models.attention.decode_attention``
  on the gathered cache (the default mode) and on the cache upcast to q's
  dtype (the upcast mode, the reference's ``decode_unroll``), for e4m3,
  int8 and bf16 pages under fp32 and bf16 q, G 1/3/16, D 64/80/120/128, a
  window at D 80 and 120. Tolerance: 1e-5 plus q's rounding of the output
  (2^-8 of it for bf16), plus ``weight_slack``, what a weight computed by
  another library to within 2^-12 may move when it rounds to the other
  neighbour of an e4m3 or int8 step. The split decode's two passes
  (stats, merge, values, sum) over two shares of the table give the
  one-call function within the same bound. int8 pages also under q times
  12 and 40, where q*scale truncates to non-zero integers and the output
  is not zeros: rows whose largest weight lies in [0.5, 1) and rows whose
  weight is exactly 1 tell truncation from rounding to nearest, and a
  function that rounds q*scale or the weights to nearest, or writes
  zeros, lies beyond the bound.
* The same pages through the reference's Pallas kernel in interpret mode:
  the distance between the reference's two functions is recorded. With
  int8 pages ``decode_attention`` returns zeros (q*scale truncates to 0 and
  so do the normalised weights) where the Pallas kernel returns the mean of
  v (it rounds the unnormalised exp(0) = 1); the port computes the former.
* ``Transformer.prefill``/``decode_step`` against the reference's
  ``prefill``/``decode_step`` under the same ``ParallelContext(kv_cache_dtype=)``,
  fp32 weights, two prompts and 4 decode steps: llama3.2-3b, h2o-danube
  (its window binds), phi3.5-moe, zamba2, xlstm (fp8, int8, bf16) and
  deepseek-r1 (bf16, int8), logits within ``ATOL`` with argmax equal, and
  under ``decode_unroll`` (the cache read upcast) for llama3.2-3b and
  h2o-danube;
  xlstm's equal to its fp32-cache logits (it has no attention cache), as
  the reference's are; deepseek-r1 with fp8 raises on both sides.
* The port's engine on ``TorchRunner(cache_dtype=)`` against the JAX
  engine on ``JaxRunner(cache_dtype=)``: equal tokens, preemptions and
  counts, with and without preemption. zamba2 and xlstm (int8, fp8)
  against a ``JaxRunner`` whose recurrent states start in the model's
  dtype, the reference's ``prefill`` + ``decode_step`` function (the
  unchanged ``JaxRunner`` truncates them into int8 and raises under fp8:
  ROADMAP §3); and on gloo CPU ranks of a (1,2)
  and a (2,1) mesh, and under ``seq_shard_decode`` (two passes split over
  the ranks), against ``JaxRunner`` on the same ``AxisType.Auto`` mesh.
* On meta (the dry-run) a quantised cache builds and counts as before.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.runner import JaxRunner
from repro.kernels.paged_attention.ops import paged_attention as pallas_paged_attention
from repro.models import transformer as T
from repro.models.attention import decode_attention
from repro.parallel.sharding import ParallelContext as JaxContext
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.runner import TorchRunner
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (INT8_EDGE, NEG_INF, decode_weights,
                                                     weight_slack)
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import make_requests
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.cache_dtype import to_cache_dtype
from repro_torch.models.transformer import Transformer, cache_dtype_of
from repro_torch.parallel.sharding import ParallelContext, make_test_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DTYPES = {"fp8": torch.float8_e4m3fn, "int8": torch.int8, "bf16": torch.bfloat16,
          "fp32": torch.float32}
JNP = {torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.int8: jnp.int8,
       torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
# logits of the port against the reference's under the same cache dtype:
# the same function, fp32 sums in another order (as tests/test_torch_model.py),
# plus, where the weights are rounded to the cache's dtype, what one weight
# computed to within an ulp and rounded to the other neighbour moves them
# by: a bf16 step is 2^-8 of the weight, an e4m3 step 2^-3 (int8 rounds a
# weight below 1 to 0 whichever its ulps). Seen here: up to 1.9e-4 (a bf16
# flip in h2o-danube's window), 7.8e-5 without one.
ATOL = 1e-4
XLSTM_ATOL = 3e-4
FLIP_ATOL = {"bf16": 1e-3, "fp8": 1e-2, "int8": 0.0}


def _jnp(t: torch.Tensor):
    """A torch tensor as a JAX array of the matching dtype (exact)."""
    return jnp.asarray(t.float().numpy()).astype(JNP[t.dtype])


# ------------------------------------------------------------------ casts
def _grid() -> np.ndarray:
    """Every finite e4m3 value and each tie between neighbours (both
    signs), the edges of e4m3's and int8's ranges, specials and a spread
    of normals."""
    e4m3 = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = np.sort(np.unique(e4m3.astype(np.float32)[np.isfinite(e4m3.astype(np.float32))]))
    ties = (vals[1:] + vals[:-1]) / 2
    edges = np.array([448, 449, 463.99, 464, 464.01, 480, 500, 1e4, 127, 127.5, 128,
                      128.9, 300.7, 0.99, 1.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
                      1e-30], np.float32)
    rng = np.random.default_rng(0)
    spread = (rng.standard_normal(2000) * np.exp(rng.uniform(-12, 7, 2000))).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)
    return np.concatenate([vals, ties, edges, -edges, spread, special]).astype(np.float32)


@pytest.mark.parametrize("name", ["fp8", "int8", "bf16"])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_to_cache_dtype_casts_as_jnp_astype(name, src):
    dtype = DTYPES[name]
    x = torch.from_numpy(_grid()).to(src)
    want = np.asarray(_jnp(x).astype(JNP[dtype]).astype(jnp.float32))
    got = to_cache_dtype(x, dtype).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_torch_casts_differ_where_the_reference_does_not():
    """What ``to_cache_dtype`` is for: torch's own ``.to`` wraps int8 and
    saturates e4m3 where ``jnp.astype`` saturates int8 and gives NaN."""
    x = torch.tensor([-300.7, 500.0])
    assert x.to(torch.int8).tolist() == [-44, -12]
    assert to_cache_dtype(x, torch.int8).tolist() == [-128, 127]
    assert x.to(torch.float8_e4m3fn).float().tolist() == [-288.0, 448.0]
    got = to_cache_dtype(x, torch.float8_e4m3fn).float()
    assert got[0] == -288.0 and torch.isnan(got[1])


# ------------------------------------------------------------------ K2
PAIRS = [("fp8", "fp32"), ("fp8", "bf16"), ("int8", "fp32"), ("int8", "bf16"),
         ("bf16", "fp32")]
PAGE, NBLK = 16, 8


def _cache(rng, shape, dtype):
    """Normal values cast to the cache's dtype; int8's at a scale that
    keeps a spread of small integers, as O(1) activations give."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return to_cache_dtype(x * (3.0 if dtype == torch.int8 else 1.0), dtype)


def _k2_inputs(seed, pages, qdt, B=3, KV=2, G=3, D=64, P=24):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, D)).astype(np.float32)).to(qdt)
    kp, vp = (_cache(rng, (P, PAGE, KV, D), pages) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(P)[:B * NBLK].reshape(B, NBLK).astype(np.int32))
    lens = torch.tensor([NBLK * PAGE - 1, 40, 5][:B], dtype=torch.int32)
    return q, kp, vp, tables, lens


def _reference(q, kp, vp, tables, lens, window, upcast):
    """``decode_attention`` on the table's pages gathered into a dense cache
    of the pages' dtype (upcast: of q's)."""
    B, KV, G, D = q.shape
    kc, vc = (_jnp(p[tables.long()].reshape(B, -1, KV, D)) for p in (kp, vp))
    if upcast:
        kc, vc = kc.astype(JNP[q.dtype]), vc.astype(JNP[q.dtype])
    out = decode_attention(_jnp(q).reshape(B, 1, KV * G, D), kc, vc,
                           jnp.asarray(lens.numpy()), window=window)
    return np.asarray(out.astype(jnp.float32)).reshape(B, KV, G, D)


# K2's bf16 tolerance (tests/test_torch_kernels.py, on values of unit
# scale; here times the values' scale), where the reference rounds q*scale
# and the weights to a bf16 q's dtype (the upcast mode) and the plain
# version keeps them in fp32, as it does for pages of a bf16 q
BF16_TOL = 2e-2


def _fp32_scale(q, kp, vp):
    """What fp32 sums in another order may move an output by: a few ulps
    of the largest |q.k| * scale (the weights' relative error) times the
    largest |v|."""
    D = q.shape[-1]
    qk = (q.float().abs().amax() * D ** -0.5 * kp.float().abs().amax() * D)
    return float(1e-6 * max(1.0, float(qk)) * vp.float().abs().amax())


def _hold(got, want, q, slack, upcast=False, fp32=0.0, v_scale=1.0):
    """|got - want| <= 1e-5 + ``fp32`` (``_fp32_scale``) + q's rounding of
    the output + the slack; upcast under a bf16 q, ``BF16_TOL`` of the
    values' scale and of |want|."""
    rel = 2.0 ** -8 if q.dtype == torch.bfloat16 else 1e-6
    bound = 1e-5 + fp32 + rel * np.abs(want) + slack
    if upcast and q.dtype == torch.bfloat16:
        bound = BF16_TOL * (v_scale + np.abs(want))
    diff = np.abs(got - want)
    assert np.isfinite(got).all()
    assert (diff <= bound).all(), float((diff - bound).max())
    return float(diff.max())


@pytest.mark.parametrize("mode", ["default", "upcast"])
@pytest.mark.parametrize("D", [64, 80, 120, 128])
@pytest.mark.parametrize("G", [1, 3, 16])
@pytest.mark.parametrize("pair", PAIRS, ids=["/".join(p) for p in PAIRS])
def test_plain_k2_is_the_reference_decode_attention(pair, G, D, mode):
    pages, qdt = (DTYPES[n] for n in pair)
    upcast = mode == "upcast"
    window = 37 if D in (80, 120) else 0
    q, kp, vp, tables, lens = _k2_inputs(G * D, pages, qdt, G=G, D=D)
    got = ops.paged_attention(q, kp, vp, tables, lens, window=window, upcast=upcast)
    assert got.dtype == qdt
    want = _reference(q, kp, vp, tables, lens, window, upcast)
    slack = weight_slack(q, kp, vp, tables, lens, window=window, upcast=upcast).numpy()
    _hold(got.float().numpy(), want, q, slack, upcast, _fp32_scale(q, kp, vp),
          float(vp.float().std()))
    if pages == torch.int8 and not upcast:
        # q*scale (|q| < 8 here) truncates to 0, and so does every
        # normalised weight below 1: the reference's function is zeros
        assert not got.float().abs().max()


# q times these reaches int8's steps: q*scale truncates to integers of a
# few units, so scores spread by tens; at x12 most rows' largest weight
# lies in [0.5, 1) (truncated to 0, where rounding to nearest gives 1), at
# x40 most rows' is exactly 1 (the output is that key's v)
INT8_QX = (12.0, 40.0)


@pytest.mark.parametrize("qx", INT8_QX)
@pytest.mark.parametrize("D", [64, 80, 120, 128])
@pytest.mark.parametrize("G", [1, 3, 16])
@pytest.mark.parametrize("qdt", ["fp32", "bf16"])
def test_plain_k2_on_int8_scores_is_the_reference_decode_attention(qdt, G, D, qx):
    """int8 pages under a q large enough that q*scale truncates to
    non-zero integers: the reference's output is non-zero, and rows whose
    largest weight lies in [0.5, 1) tell truncation from rounding."""
    q, kp, vp, tables, lens = _k2_inputs(G * D + int(qx), torch.int8, torch.float32,
                                         KV=4, G=G, D=D)
    q = (q * qx).to(DTYPES[qdt])
    window = 37 if D in (80, 120) else 0
    got = ops.paged_attention(q, kp, vp, tables, lens, window=window)
    want = _reference(q, kp, vp, tables, lens, window, False)
    slack = weight_slack(q, kp, vp, tables, lens, window=window).numpy()
    _hold(got.float().numpy(), want, q, slack, fp32=_fp32_scale(q, kp, vp))
    top = decode_weights(q, kp, tables, lens, window).amax(dim=-1).numpy()
    nonzero = np.abs(want).max(axis=-1) > 0
    print(f"int8 q x{qx}: rows non-zero {nonzero.mean():.2f}, largest weight in "
          f"[0.5, 1) {((top >= 0.5) & (top < 1)).mean():.2f}, with slack "
          f"{(slack.max(axis=-1) > 0).mean():.2f}")
    exact = slack.max(axis=-1) == 0
    assert (nonzero == (top == 1))[exact].all()
    if qx == INT8_QX[0]:
        assert ((top >= 0.5) & (top < 1)).any()
    else:
        assert (nonzero & exact).any()


# one sequence past the 12,288 tokens at G 16 that the cluster's scores
# held before it took every length (the two passes ran there), at a narrow
# D and two kv heads: (pages, q, q times)
LONG_PAIRS = [("fp8", "fp32", 1.0), ("int8", "bf16", 40.0)]


@pytest.mark.parametrize("pages,qdt,qx", LONG_PAIRS,
                         ids=[f"{p}/{q}" for p, q, _ in LONG_PAIRS])
def test_plain_k2_past_the_old_cluster_limit_is_the_reference_decode_attention(
        pages, qdt, qx):
    """13,000 tokens at G 16 in shuffled pages: the plain version (which
    the card's kernel is held to) is ``decode_attention`` itself."""
    pages, qdt = DTYPES[pages], DTYPES[qdt]
    B, KV, G, D, tokens = 1, 2, 16, 32, 13_000
    nblk = -(-tokens // PAGE)
    rng = np.random.default_rng(2700)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, D)).astype(np.float32) * qx).to(qdt)
    kp, vp = (_cache(rng, (nblk + 3, PAGE, KV, D), pages) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(nblk + 3)[:nblk][None].astype(np.int32))
    lens = torch.tensor([tokens - 1], dtype=torch.int32)
    got = ops.paged_attention(q, kp, vp, tables, lens)
    want = _reference(q, kp, vp, tables, lens, 0, False)
    slack = weight_slack(q, kp, vp, tables, lens).numpy()
    _hold(got.float().numpy(), want, q, slack, fp32=_fp32_scale(q, kp, vp))
    assert np.abs(want).max() > 0


def test_int8_checks_tell_truncation_from_rounding():
    """The int8 inputs above catch a function that rounds q*scale or the
    weights to nearest instead of truncating, or that writes zeros: each
    lies beyond the bound the kernels are held to."""
    q, kp, vp, tables, lens = _k2_inputs(5, torch.int8, torch.float32, G=3, D=128)
    B, KV, G, D = q.shape
    vc = vp[tables.long()].reshape(B, -1, KV, D).float()
    for qx in INT8_QX:
        qq = q * qx
        want = ops.paged_attention(qq, kp, vp, tables, lens).numpy()
        slack = weight_slack(qq, kp, vp, tables, lens).numpy()
        bound = 1e-5 + _fp32_scale(qq, kp, vp) + 1e-6 * np.abs(want) + slack
        w = decode_weights(qq, kp, tables, lens)
        rounded_w = torch.einsum("bkgs,bskd->bkgd", w.round(), vc).numpy()
        qs = torch.round(qq * D ** -0.5).clamp(-128, 127) / D ** -0.5
        rounded_q = ops.paged_attention(qs, kp, vp, tables, lens).numpy()
        for wrong in (np.zeros_like(want), rounded_w, rounded_q):
            assert (np.abs(wrong - want) > bound).any()


def _split(q, kp, vp, tables, lens, window, n_shares):
    """The table cut into ``n_shares`` runs of whole pages (a rank's share
    each, lens counted from the share's start): pass 1 on each share, the
    shares' (m, l) gathered, pass 2 on each with its scores, the sums
    gathered and added. Returns (out, each share's pass 1 (ml, scores), the
    gathered sums)."""
    cuts = np.linspace(0, tables.shape[1], n_shares + 1).round().astype(int)
    shares = [(tables[:, a:b].contiguous(), lens - int(a) * PAGE)
              for a, b in zip(cuts[:-1], cuts[1:])]
    passes = [ops.paged_attention_stats(q, kp, t, l, window=window) for t, l in shares]
    ml = torch.cat([m for m, _ in passes], dim=2)
    acc = torch.cat([ops.paged_attention_values(q, kp, vp, t, l, ml, sc, window=window)
                     for (t, l), (_, sc) in zip(shares, passes)], dim=2)
    return ops.paged_sum(acc, q.dtype), passes, acc


@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("pair", PAIRS, ids=["/".join(p) for p in PAIRS])
def test_split_passes_over_two_shares_equal_one_call(pair, window):
    """The sequence cut into two shares of 4 blocks (a rank's each, lens
    counted from the share's start): pass 1's (m, l), one a share,
    gathered, pass 2 (which merges them) on each share with its scores,
    the shares' sums gathered and added, against the one-call function."""
    pages, qdt = (DTYPES[n] for n in pair)
    q, kp, vp, tables, lens = _k2_inputs(7, pages, qdt, G=4, D=64)
    got, passes, acc = _split(q, kp, vp, tables, lens, window, 2)
    B, KV, G, D = q.shape
    for ml, scores in passes:
        assert ml.shape == (B, KV, 1, G, 2) and scores.shape == (B, KV, 4, G, PAGE)
    assert acc.shape == (B, KV, 2, G, D)
    one = ops.paged_attention(q, kp, vp, tables, lens, window=window)
    slack = weight_slack(q, kp, vp, tables, lens, window=window).numpy()
    _hold(got.float().numpy(), one.float().numpy(), q, slack, fp32=_fp32_scale(q, kp, vp))


@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("n_shares", [2, 3, 4])
@pytest.mark.parametrize("pair", PAIRS, ids=["/".join(p) for p in PAIRS])
def test_split_passes_over_shares_equal_decode_attention(pair, n_shares, window):
    """The passes over 2, 3 and 4 shares, gathered and summed, against the
    reference's ``decode_attention`` on the whole sequence. The rows' lens
    (127, 40, 5 of 128 positions) leave shares wholly past the newest
    token, and the window of 50 shares wholly before it: such a share's
    (m, l) is (NEG_INF, 0) and its sum zeros."""
    pages, qdt = (DTYPES[n] for n in pair)
    q, kp, vp, tables, lens = _k2_inputs(11, pages, qdt)
    got, passes, acc = _split(q, kp, vp, tables, lens, window, n_shares)
    ml = torch.cat([m for m, _ in passes], dim=2)
    empty = ml[..., 1] == 0                                       # (B,KV,R,G)
    assert bool(empty.any()) and bool((ml[..., 0][empty] == NEG_INF).all())
    assert bool((acc.transpose(2, 3)[empty.transpose(2, 3)] == 0).all())
    if window:   # row 0's first share lies wholly before the window
        assert bool(empty[0, :, 0].all())
    if (pair, window) not in _SPLIT_WANT:   # one reference call for every share count
        _SPLIT_WANT[pair, window] = _reference(q, kp, vp, tables, lens, window, False)
    want = _SPLIT_WANT[pair, window]
    slack = weight_slack(q, kp, vp, tables, lens, window=window).numpy()
    _hold(got.float().numpy(), want, q, slack, fp32=_fp32_scale(q, kp, vp))
    assert np.abs(want).max() > 0 or pages == torch.int8


_SPLIT_WANT = {}


# h2o-danube's rows at tp 8, one kv head of 120 a rank, and three kv heads:
# 8-bit rows whose token stride (KV x 120 bytes) is no multiple of 16, which
# the card's cluster designs read through the map over token pairs. int8
# under q x12 (``INT8_QX``), where its output is not zeros, in the modes
# that round to it (the upcast mode truncates nothing: q x1 there, as in
# the tests above)
ODD_KV_PAIRS = [("fp8", "bf16", 1.0), ("fp8", "fp32", 1.0), ("int8", "bf16", 12.0)]


@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("mode", ["default", "upcast", "split"])
@pytest.mark.parametrize("KV", [1, 3])
@pytest.mark.parametrize("pages,qdt,qx", ODD_KV_PAIRS,
                         ids=[f"{p}/{q}" for p, q, _ in ODD_KV_PAIRS])
def test_plain_k2_under_an_odd_kv_is_the_reference_decode_attention(pages, qdt, qx, KV,
                                                                    mode, window):
    """D 120 under one and three kv heads, in the three modes the card runs
    there (the default mode's one launch, the upcast mode, the sequence
    split over two shares), against ``decode_attention`` on the gathered
    cache (upcast: the cache upcast to q's dtype)."""
    pages, qdt = DTYPES[pages], DTYPES[qdt]
    q, kp, vp, tables, lens = _k2_inputs(31 + KV, pages, torch.float32, KV=KV, G=4, D=120)
    upcast = mode == "upcast"
    q = (q * (1.0 if upcast else qx)).to(qdt)
    if mode == "split":
        got = _split(q, kp, vp, tables, lens, window, 2)[0]
    else:
        got = ops.paged_attention(q, kp, vp, tables, lens, window=window, upcast=upcast)
    assert got.dtype == qdt
    want = _reference(q, kp, vp, tables, lens, window, upcast)
    slack = weight_slack(q, kp, vp, tables, lens, window=window, upcast=upcast).numpy()
    _hold(got.float().numpy(), want, q, slack, upcast, _fp32_scale(q, kp, vp),
          float(vp.float().std()))
    assert np.abs(want).max() > 0


def test_one_pass_partials_refuse_rounded_pages():
    q, kp, vp, tables, lens = _k2_inputs(1, torch.float8_e4m3fn, torch.bfloat16)
    with pytest.raises(ValueError, match="paged_attention_stats"):
        ops.paged_attention_partials(q, kp, vp, tables, lens)
    acc, ml = ops.paged_attention_partials(q, kp, vp, tables, lens, upcast=True)
    _hold(ops.paged_merge(acc, ml, q.dtype).float().numpy(),
          _reference(q, kp, vp, tables, lens, 0, True), q, 0.0, upcast=True,
          fp32=_fp32_scale(q, kp, vp), v_scale=float(vp.float().std()))


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["fp8", "int8"])
def test_the_reference_pallas_kernel_computes_another_function(name, qdt):
    """The reference's Pallas kernel (interpret mode) rounds the running
    exp(s - m) where ``decode_attention`` rounds the normalised weights. The
    port computes ``decode_attention``'s; the Pallas kernel's distance from
    it is printed. int8: ``decode_attention`` gives zeros, the Pallas kernel
    the mean of v over the valid positions."""
    pages = DTYPES[name]
    q, kp, vp, tables, lens = _k2_inputs(11, pages, qdt, G=3, D=64)
    B, KV, G, D = q.shape
    want = _reference(q, kp, vp, tables, lens, 0, False)
    port = ops.paged_attention(q, kp, vp, tables, lens).float().numpy()
    pallas = np.asarray(pallas_paged_attention(
        _jnp(q).reshape(B, KV * G, D), _jnp(kp), _jnp(vp), jnp.asarray(tables.numpy()),
        jnp.asarray(lens.numpy()), interpret=True).astype(jnp.float32)).reshape(B, KV, G, D)
    slack = weight_slack(q, kp, vp, tables, lens).numpy()
    port_err = _hold(port, want, q, slack, fp32=_fp32_scale(q, kp, vp))
    pallas_err = float(np.abs(pallas - want).max())
    print(f"{name} pages, {qdt} q: port {port_err:.3g}, Pallas kernel {pallas_err:.3g} "
          f"from decode_attention (largest |out| {float(np.abs(want).max()):.3g})")
    assert pallas_err > 10 * port_err
    if pages == torch.int8:
        assert not np.abs(want).max()
        vc = vp[tables.long()].reshape(B, -1, KV, D).float()
        mean = torch.stack([vc[b, :int(lens[b]) + 1].mean(0) for b in range(B)])
        np.testing.assert_allclose(pallas, mean[:, :, None, :].expand(B, KV, G, D).numpy(),
                                   rtol=2.0 ** -7, atol=1e-5)


# int8 rows at the edge (``INT8_EDGE``): one key holds the row's largest
# score and the other keys' exp(score - max) sum to s in [2^-26, 2^-14].
# The largest weight 1 / (1 + s) is exactly 1 (truncated to 1: the output is
# that key's v) where the fp32 sum 1 + s rounds to 1, else below 1
# (truncated to 0: zeros). Which side a row falls on depends on s and on
# the order the sum adds its terms (the largest first or last). Each row:
# (gaps between the largest score and the others', the largest key's
# position); the last row's s lies below the edge.
INT8_EDGE_ROWS = [([10], 5), ([16], 5), ([17], 5), ([17, 17], 0), ([17, 17], 31),
                  ([17, 17, 17], 3), ([18, 18, 18], 10), ([17] * 6, 20), ([16, 30], 7),
                  ([25] * 20, 1)]


def test_int8_edge_rows_fall_on_the_reference_side():
    """Rows whose other keys' exp sum lies in ``INT8_EDGE``, against
    ``repro.models.attention.decode_attention`` itself: the side of 1 the
    reference's own sum falls on (printed) is the plain version's, row by
    row, and both sides occur. ``weight_slack`` marks exactly the rows in
    the edge, which a kernel summing in another order may put on the
    other side."""
    B, KV, G, D, nblk = len(INT8_EDGE_ROWS), 1, 1, 64, 2
    rng = np.random.default_rng(26)
    kp = np.zeros((B * nblk, PAGE, KV, D), np.float32)
    vp = np.zeros_like(kp)
    tables = np.arange(B * nblk, dtype=np.int32).reshape(B, nblk)
    lens, sums = [], []
    for b, (gaps, top) in enumerate(INT8_EDGE_ROWS):
        others = [p for p in range(nblk * PAGE) if p != top][:len(gaps)]
        k = np.zeros((nblk * PAGE, KV, D), np.float32)   # other positions score 0
        k[top, 0, 0] = 100.0
        for gap, p in zip(gaps, others):
            k[p, 0, 0] = 100.0 - gap
        kp[tables[b]] = k.reshape(nblk, PAGE, KV, D)
        vp[tables[b]] = rng.integers(-5, 6, (nblk, PAGE, KV, D))
        lens.append(max(top, *others))
        sums.append(sum(np.exp(-np.float64(g)) for g in gaps))
    # q*scale truncates to the unit vector: a key's score is its k[0]
    q = np.zeros((B, KV, G, D), np.float32)
    q[..., 0] = D ** 0.5
    qt = torch.from_numpy(q)
    kt, vt = (torch.from_numpy(a).to(torch.int8) for a in (kp, vp))
    tt, lt = torch.from_numpy(tables), torch.tensor(lens, dtype=torch.int32)
    got = ops.paged_attention(qt, kt, vt, tt, lt).numpy()[:, 0, 0]
    want = _reference(qt, kt, vt, tt, lt, 0, False)[:, 0, 0]
    slack = weight_slack(qt, kt, vt, tt, lt).numpy()[:, 0, 0].max(axis=-1)
    sides = [int(np.abs(row).max() > 0) for row in want]
    print("int8 edge rows, the reference's side of 1 (1: the largest weight is 1):",
          [(f"{s:.3g}", side) for s, side in zip(sums, sides)])
    for b, (s, side) in enumerate(zip(sums, sides)):
        in_edge = INT8_EDGE[0] <= s <= INT8_EDGE[1]
        assert bool(slack[b] > 0) == in_edge, (b, s)
        top = INT8_EDGE_ROWS[b][1]
        v_top = vp[tables[b]].reshape(-1, KV, D)[top, 0]
        np.testing.assert_array_equal(want[b], v_top if side else np.zeros(D))
        np.testing.assert_array_equal(got[b], want[b])
    assert set(sides[:-1]) == {0, 1}


@pytest.mark.parametrize("D", [64, 80, 120, 128])
@pytest.mark.parametrize("G", [1, 3, 16])
def test_plain_k2_upcasts_fp32_pages_as_the_unrolled_decode(G, D):
    """fp32 pages under a bf16 q in the upcast mode: the reference's
    unrolled decode reads ``kc[l].astype(q.dtype)``
    (``src/repro/models/transformer.py:487-488``), the cache rounded down
    to bf16 before ``decode_attention``; the plain version rounds the pages
    to bf16 alike and attends in fp32 (the upcast mode's bound)."""
    window = 37 if D in (80, 120) else 0
    q, kp, vp, tables, lens = _k2_inputs(G * D + 26, torch.float32, torch.bfloat16, G=G, D=D)
    got = ops.paged_attention(q, kp, vp, tables, lens, window=window, upcast=True)
    assert got.dtype == torch.bfloat16
    want = _reference(q, kp, vp, tables, lens, window, True)
    _hold(got.float().numpy(), want, q, 0.0, True, _fp32_scale(q, kp, vp),
          float(vp.float().std()))
    # the rounding is the reference's: the plain version on the pages cast
    # to bf16 first is the same function
    same = ops.paged_attention(q, kp.to(torch.bfloat16), vp.to(torch.bfloat16), tables, lens,
                               window=window)
    np.testing.assert_array_equal(got.float().numpy(), same.float().numpy())


# ------------------------------------------------------------------ model
MODEL_CASES = [(a, c) for a in ("llama3.2-3b", "h2o-danube-3-4b", "phi3.5-moe-42b-a6.6b",
                                "zamba2-2.7b", "xlstm-350m")
               for c in ("fp8", "int8", "bf16")] + [("deepseek-r1-671b", "bf16"),
                                                    ("deepseek-r1-671b", "int8")]
S, STEPS = 10, 4


def _params(arch):
    jcfg = jax_smoke_config(arch)
    ctx = JaxContext()
    params = T.init_params(jcfg, jax.random.PRNGKey(0), ctx, mode="serve",
                           dtype=jnp.float32)
    return jcfg, params


def _jax_states(cfg, state):
    if cfg.family == "hybrid":
        h, cs = state["mamba"]
        return [h, *cs]
    if cfg.family == "ssm":
        return ([a.reshape(-1, *a.shape[2:]) for a in state["mlstm"]]
                + list(state["slstm"]))
    return []


def _serve_both(arch, cache, unroll=False):
    """Two prompts prefilled and STEPS greedy decode steps on both sides
    under ``kv_cache_dtype=cache`` (and ``decode_unroll``); returns each
    step's logits, port and reference."""
    jcfg, params = _params(arch)
    cfg = get_smoke_config(arch)
    cdt = DTYPES[cache]
    jctx = JaxContext(kv_cache_dtype=JNP[cdt], decode_unroll=unroll)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu", ctx=ParallelContext(kv_cache_dtype=cdt,
                                                              decode_unroll=unroll))
    window = cfg.swa_window if cfg.attention == "swa" else 0
    rng = np.random.default_rng(len(arch))
    B, L = 2, S + window
    tokens = rng.integers(0, cfg.vocab, size=(B, L)).astype(np.int32)
    jlast, state = jax.jit(lambda p, t: T.prefill(
        p, t, jcfg, jctx, max_len=L + STEPS, cache_dtype=jnp.float32))(params, jnp.asarray(tokens))
    jdecode = jax.jit(lambda p, st, t: T.decode_step(p, st, t, jcfg, jctx))
    last, caches, states = model.prefill(torch.from_numpy(tokens).long())
    nblk = -(-(L + STEPS) // PAGE)
    n_pages = 3 * B * nblk
    tables = rng.permutation(n_pages)[:B * nblk].reshape(B, nblk).astype(np.int32)
    pools = [torch.zeros(s, dtype=model.pool_dtype()) for s in model.pool_shapes(n_pages, PAGE)]
    pos = np.arange(L)
    for b in range(B):
        pages = torch.from_numpy(tables[b, pos // PAGE]).long()
        offs = torch.from_numpy(pos % PAGE)
        for j, pool in enumerate(pools):
            pool.view(torch.uint8 if cdt == torch.float8_e4m3fn else cdt)[:, pages, offs] = \
                to_cache_dtype(torch.stack([c[j] for c in caches])[:, b], cdt).view(
                    torch.uint8 if cdt == torch.float8_e4m3fn else cdt)
    rows = torch.tensor([1, 0])
    bufs = [torch.zeros(shape, dtype=dt) for shape, dt in model.state_shapes(B)]
    for buf, st in zip(bufs, states):
        buf[:, rows] = st
    steps = [(last.numpy(), np.asarray(jlast))]
    nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
    for i in range(STEPS):
        jlogits, state = jdecode(params, state, jnp.asarray(nxt[:, None]))
        logits = model.decode_step(torch.from_numpy(nxt).long(), torch.full((B,), L + i),
                                   pools, torch.from_numpy(tables), bufs, rows)
        steps.append((logits.numpy(), np.asarray(jlogits[:, 0])))
        nxt = np.array(jnp.argmax(jlogits[:, 0], axis=-1), np.int32)
    return steps


@pytest.mark.parametrize("arch,cache", MODEL_CASES,
                         ids=[f"{a}-{c}" for a, c in MODEL_CASES])
def test_decode_with_a_cache_dtype_matches_the_reference(arch, cache):
    atol = (XLSTM_ATOL if arch == "xlstm-350m" else ATOL) + FLIP_ATOL[cache]
    worst = 0.0
    for mine, ref in _serve_both(arch, cache):
        np.testing.assert_allclose(mine, ref, rtol=0, atol=atol)
        assert (mine.argmax(-1) == ref.argmax(-1)).all()
        worst = max(worst, float(np.abs(mine - ref).max()))
    print(arch, cache, "max |logits - reference|", worst)


@pytest.mark.parametrize("arch,cache", [("llama3.2-3b", "fp8"), ("llama3.2-3b", "int8"),
                                        ("h2o-danube-3-4b", "fp8")])
def test_decode_unroll_reads_the_cache_upcast_as_the_reference(arch, cache):
    """Under ``decode_unroll`` the reference's unrolled decode upcasts the
    cache to the model's dtype before ``decode_attention``: no rounding of
    q*scale or the weights (an int8 cache no longer decodes to zeros)."""
    steps = _serve_both(arch, cache, unroll=True)
    for mine, ref in steps:
        np.testing.assert_allclose(mine, ref, rtol=0, atol=ATOL)
        assert (mine.argmax(-1) == ref.argmax(-1)).all()
    rounded = _serve_both(arch, cache)
    moved = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(steps[1:], rounded[1:]))
    print(arch, cache, "reference logits, upcast against rounded:", moved)
    assert moved > 10 * ATOL


def test_xlstm_logits_do_not_move_with_the_cache_dtype():
    """xlstm has no attention cache and its states stay in the model's
    dtype, so its logits under an int8 or fp8 cache are its fp32-cache
    logits, as the reference's are; zamba2's attention cache moves its
    logits under fp8 on both sides alike."""
    base = [m for m, _ in _serve_both("xlstm-350m", "fp32")]
    for cache in ("int8", "fp8"):
        for got, want in zip((m for m, _ in _serve_both("xlstm-350m", cache)), base):
            np.testing.assert_array_equal(got, want)
    z32 = _serve_both("zamba2-2.7b", "fp32")
    z8 = _serve_both("zamba2-2.7b", "fp8")
    moved = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(z8, z32))
    ref_moved = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(z8, z32))
    print("zamba2 fp8 against fp32 cache: port", moved, "reference", ref_moved)
    assert moved > 1e-3 and abs(moved - ref_moved) <= 1e-3


def test_mla_with_fp8_raises_on_both_sides():
    jcfg, params = _params("deepseek-r1-671b")
    jctx = JaxContext(kv_cache_dtype=jnp.float8_e4m3fn)
    tokens = jnp.zeros((1, 6), jnp.int32)
    _, state = T.prefill(params, tokens, jcfg, jctx, max_len=8)
    with pytest.raises(Exception) as e:
        T.decode_step(params, state, tokens[:, :1], jcfg, jctx)
    assert type(e.value).__name__ == "TypePromotionError"
    ctx = ParallelContext(kv_cache_dtype=torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError, match="TypePromotionError"):
        Transformer(get_smoke_config("deepseek-r1-671b"), device="cpu", seed=None, ctx=ctx)
    with pytest.raises(NotImplementedError, match="TypePromotionError"):
        TorchRunner(Transformer(get_smoke_config("deepseek-r1-671b"), device="cpu",
                                dtype=torch.float32, seed=0), device="cpu",
                    cache_dtype=torch.float8_e4m3fn)


def test_mla_with_a_wider_cache_raises_in_the_reference_decode():
    """bf16 MLA over an fp32 cache: the reference's prefill builds the
    cache, and its first ``decode_step`` raises the scan's carry
    ``TypeError`` (``mla_decode`` promotes against the fp32 latents). The
    port refuses the same pair and names that failure."""
    jcfg = jax_smoke_config("deepseek-r1-671b")
    jctx = JaxContext()
    params = T.init_params(jcfg, jax.random.PRNGKey(0), jctx, mode="serve",
                           dtype=jnp.bfloat16)
    tokens = jnp.zeros((1, 6), jnp.int32)
    _, state = T.prefill(params, tokens, jcfg, jctx, max_len=8, cache_dtype=jnp.float32)
    assert state["caches"]["dense_stack"]["ckv"].dtype == jnp.float32
    with pytest.raises(TypeError, match="carry"):
        T.decode_step(params, state, tokens[:, :1], jcfg, jctx)
    cfg = get_smoke_config("deepseek-r1-671b")
    with pytest.raises(NotImplementedError, match="decode_step raises TypeError"):
        cache_dtype_of(cfg, ParallelContext(), torch.bfloat16, torch.float32)
    with pytest.raises(NotImplementedError, match="layer scan"):
        TorchRunner(Transformer(cfg, device="cpu", dtype=torch.bfloat16, seed=0),
                    device="cpu", cache_dtype=torch.float32)
    # the same model over a cache of its own dtype decodes on both sides
    assert cache_dtype_of(cfg, ParallelContext(), torch.bfloat16) == torch.bfloat16


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_a_quantised_cache_builds_on_meta(name):
    """The dry-run's half of the old refusal test: on meta the model builds
    under a mesh with the cache dtype, and its pools take it."""
    from repro_torch.parallel.sharding import AbstractMesh
    ctx = ParallelContext(mesh=AbstractMesh((1, 2), ("data", "model")),
                          kv_cache_dtype=DTYPES[name])
    m = Transformer(get_smoke_config("llama3.2-3b"), device="meta",
                    dtype=torch.bfloat16, seed=None, ctx=ctx)
    assert m.pool_dtype() == DTYPES[name]


def test_the_pool_dtype_follows_the_context_then_the_runner():
    cfg = get_smoke_config("llama3.2-3b")
    m = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    assert TorchRunner(m, device="cpu").cache_dtype == torch.float32
    assert TorchRunner(m, device="cpu", cache_dtype=torch.int8).cache_dtype == torch.int8
    m8 = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0,
                     ctx=ParallelContext(kv_cache_dtype=torch.float8_e4m3fn))
    assert TorchRunner(m8, device="cpu", cache_dtype=torch.int8).cache_dtype \
        == torch.float8_e4m3fn


# ------------------------------------------------------------------ engine
ENGINE_CASES = [("llama3.2-3b", c, pool) for c in ("fp8", "int8", "bf16")
                for pool in (64, 7)] + [("h2o-danube-3-4b", "fp8", 7)]


@pytest.mark.parametrize("arch,cache,n_pages", ENGINE_CASES,
                         ids=[f"{a}-{c}-{n}pages" for a, c, n in ENGINE_CASES])
def test_engine_on_torch_runner_equals_the_jax_engine(arch, cache, n_pages):
    jcfg, params = _params(arch)
    cfg = get_smoke_config(arch)
    cdt = DTYPES[cache]
    rng = np.random.default_rng(1)
    extra = cfg.swa_window if cfg.attention == "swa" else 0
    prompts = [rng.integers(0, cfg.vocab, size=30 + extra).tolist() for _ in range(3)]
    n_new = [20, 12, 16]
    ecfg = dict(n_pages=n_pages, max_num_seqs=4, max_num_batched_tokens=512,
                chunk_size=192, admission_mode="naive")
    jeng = JaxEngine(jcfg, JaxEngineConfig(**ecfg), JaxRunner(
        jcfg, params, JaxContext(), max_slots=4, max_len=192, cache_dtype=JNP[cdt]),
        virtual_clock=False)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    eng = InferenceEngine(cfg, EngineConfig(**ecfg),
                          TorchRunner(model, device="cpu", cache_dtype=cdt),
                          virtual_clock=False)
    runs = []
    for e in (jeng, eng):
        reqs = [e.submit(p, n) for p, n in zip(prompts, n_new)]
        e.run(max_steps=2000)
        s = e.metrics.summary()
        runs.append(([r.output for r in reqs], sum(r.n_preemptions for r in reqs),
                     {k: s[k] for k in ("n_finished", "gen_tokens", "preemptions")},
                     e.step_idx if hasattr(e, "step_idx") else None))
    assert runs[1] == runs[0]
    assert eng.runner.pools[0].dtype == cdt
    if n_pages == 7:
        assert runs[0][1] > 0, "the pool was sized to force preemption"


RECURRENT_CASES = [(a, c) for a in ("zamba2-2.7b", "xlstm-350m") for c in ("int8", "fp8")]


def _run_engine(eng, prompts, n_new):
    reqs = [eng.submit(p, n) for p, n in zip(prompts, n_new)]
    eng.run(max_steps=2000)
    s = eng.metrics.summary()
    return ([r.output for r in reqs],
            {k: s[k] for k in ("n_finished", "gen_tokens", "preemptions")})


@pytest.mark.parametrize("arch,cache", RECURRENT_CASES,
                         ids=[f"{a}-{c}" for a, c in RECURRENT_CASES])
def test_recurrent_states_follow_the_reference_function_not_jax_runner(arch, cache):
    """The recurrent conv states (ROADMAP §3). ``JaxRunner`` allocates them
    in the cache's dtype and its prefill scatter casts the prefill's
    model-dtype states into them: int8 truncates them (until its first
    decode step promotes the buffers), fp8 raises ``TypePromotionError``.
    The reference's ``prefill`` + ``decode_step`` keep them in the model's
    dtype, and so does the port: its engine's tokens equal the JAX engine's
    on a ``JaxRunner`` whose recurrent states start in the model's dtype
    (its attention pools in the cache's), and differ from the unchanged
    ``JaxRunner``'s under int8."""
    jcfg, params = _params(arch)
    cfg = get_smoke_config(arch)
    cdt = DTYPES[cache]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=30).tolist() for _ in range(3)]
    n_new = [20, 12, 16]
    ecfg = dict(n_pages=64, max_num_seqs=4, max_num_batched_tokens=512, chunk_size=192,
                admission_mode="naive")
    # 6 slots: unequal to every dim of the decode state (JaxRunner's rule)
    runners = [JaxRunner(jcfg, params, JaxContext(), max_slots=6, max_len=192,
                         cache_dtype=JNP[cdt]) for _ in range(2)]
    model_dtype = T.init_decode_state(jcfg, JaxContext(), 6, 192, jnp.float32)
    recurrent = {"mamba", "mlstm"} & set(model_dtype)
    # the conv states are the recurrent leaves in the cache's dtype
    assert recurrent and any(leaf.dtype == JNP[cdt] for key in recurrent
                             for leaf in jax.tree_util.tree_leaves(runners[1].state[key]))
    runners[0].state = {k: model_dtype[k] if k in recurrent else v
                        for k, v in runners[0].state.items()}
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    port = _run_engine(InferenceEngine(cfg, EngineConfig(**ecfg), TorchRunner(
        model, device="cpu", cache_dtype=cdt), virtual_clock=False), prompts, n_new)
    reference = _run_engine(JaxEngine(jcfg, JaxEngineConfig(**ecfg), runners[0],
                                      virtual_clock=False), prompts, n_new)
    assert port == reference
    unchanged = JaxEngine(jcfg, JaxEngineConfig(**ecfg), runners[1], virtual_clock=False)
    if cache == "fp8":
        with pytest.raises(Exception) as e:
            _run_engine(unchanged, prompts, n_new)
        assert type(e.value).__name__ == "TypePromotionError"
    else:
        assert _run_engine(unchanged, prompts, n_new)[0] != port[0]


# ------------------------------------------------------------------ mesh
MESH_CASES = {
    "fp8-1x2": ((1, 2), {}, "fp8", dict(n_pages=7)),
    "int8-2x1": ((2, 1), {}, "int8", dict(n_pages=7)),
    "fp8-2x1": ((2, 1), {}, "fp8", dict(n_pages=64)),
    # a rank's share is 12 of 24 pages of 4 tokens, which the longer
    # sequences pass: the two passes split over "model"
    "fp8-seq_shard_decode-1x2": ((1, 2), {"seq_shard_decode": True}, "fp8",
                                 dict(n_pages=24, page_size=4, admission_mode="kv_aware")),
}
MESH_SLOTS, MESH_MAX_LEN = 6, 64
MESH_ENGINE = dict(max_num_seqs=MESH_SLOTS, max_num_batched_tokens=512, chunk_size=16,
                   admission_mode="naive")

MESH_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config
    from repro.core.engine import EngineConfig, InferenceEngine
    from repro.core.runner import JaxRunner
    from repro.models import transformer as T
    from repro.parallel.sharding import ParallelContext

    spec = json.load(open(sys.argv[1]))
    out = sys.argv[2]
    dtypes = {"fp8": jnp.float8_e4m3fn, "int8": jnp.int8}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    cfg = get_smoke_config("llama3.2-3b")
    for name, (shape, opts, cache, pool) in spec["cases"].items():
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        ctx = ParallelContext(mesh=mesh, kv_cache_dtype=dtypes[cache], **opts)
        params = T.init_params(cfg, jax.random.PRNGKey(0), ctx, mode="serve",
                               dtype=jnp.float32)
        runner = JaxRunner(cfg, jax.device_put(params, T.param_shardings(cfg, ctx, "serve")),
                           ctx, max_slots=spec["slots"], max_len=spec["max_len"])
        eng = InferenceEngine(cfg, EngineConfig(**spec["engine"][name]), runner,
                              virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in spec["requests"][name]]
        eng.run(max_steps=2000)
        np.savez(os.path.join(out, name + ".npz"), **dict(flat(params)))
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(dict(outputs=[r.output for r in reqs],
                           preemptions=sum(r.n_preemptions for r in reqs)), f)
""")


def _mesh_requests(name):
    """Prompts of two lengths in turn (each one compile of the reference's
    prefill)."""
    cfg = get_smoke_config("llama3.2-3b")
    lo, hi = (20, 40) if "seq_shard" in name else (9, 31)
    reqs = make_requests(cfg.vocab, 4, (hi, hi), (8, 14), seed=len(name))
    return [(p[:(lo + 1, hi)[i % 2]], n) for i, (p, n) in enumerate(reqs)]


def _mesh_engine(name):
    return dict(MESH_ENGINE, **MESH_CASES[name][3])


def _nest(flat):
    nested = {}
    for k, v in flat.items():
        node = nested
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return nested


def _mesh_rank(rank, ref, out):
    for name, (shape, opts, cache, _) in MESH_CASES.items():
        ctx = ParallelContext(mesh=make_test_mesh(*shape), kv_cache_dtype=DTYPES[cache],
                              **opts)
        z = np.load(os.path.join(ref, name + ".npz"))
        model = from_jax_params(_nest({k: z[k] for k in z.files}),
                                get_smoke_config("llama3.2-3b"), device="cpu",
                                dtype=torch.float32, ctx=ctx)
        runner = TorchRunner(model, device="cpu")
        if not runner.leads:
            runner.follow()
            continue
        try:
            eng = InferenceEngine(get_smoke_config("llama3.2-3b"),
                                  EngineConfig(**_mesh_engine(name)), runner,
                                  virtual_clock=False)
            reqs = [eng.submit(p, n) for p, n in _mesh_requests(name)]
            eng.run(max_steps=2000)
        finally:
            runner.close()
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(dict(outputs=[r.output for r in reqs],
                           preemptions=sum(r.n_preemptions for r in reqs),
                           pool_dtype=str(runner.pools[0].dtype),
                           share=runner.share_blocks * eng.ecfg.page_size,
                           longest=max(len(r.prompt) + len(r.output) for r in reqs)), f)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    ref = tmp_path_factory.mktemp("reference")
    out = tmp_path_factory.mktemp("ranks")
    spec = ref / "spec.json"
    spec.write_text(json.dumps({
        "cases": MESH_CASES, "slots": MESH_SLOTS, "max_len": MESH_MAX_LEN,
        "engine": {n: _mesh_engine(n) for n in MESH_CASES},
        "requests": {n: _mesh_requests(n) for n in MESH_CASES}}))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", MESH_REFERENCE, str(spec), str(ref)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    run_ranks(_mesh_rank, 2, (str(ref), str(out)))
    return ({n: json.loads((out / f"{n}.json").read_text()) for n in MESH_CASES},
            {n: json.loads((ref / f"{n}.json").read_text()) for n in MESH_CASES})


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_runner_on_a_mesh_equals_the_reference_engine(mesh_results, name):
    got, want = mesh_results
    g, w = got[name], want[name]
    assert [len(t) for t in g["outputs"]] == [n for _, n in _mesh_requests(name)]
    assert g["outputs"] == w["outputs"]
    assert g["preemptions"] == w["preemptions"]
    assert g["pool_dtype"] == str(DTYPES[MESH_CASES[name][2]])
    if MESH_CASES[name][3]["n_pages"] == 7:
        assert g["preemptions"] > 0
    if "seq_shard_decode" in MESH_CASES[name][1]:
        assert g["longest"] > g["share"]
