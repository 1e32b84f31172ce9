"""The port's attention kernels against the JAX package.

On the CPU each wrapper runs its plain version, which is held against the
JAX oracles (``flash_attention_ref``, ``paged_attention_ref``), a few
interpret-mode Pallas runs, and the JAX model attention; the paged version
with a sliding window, which the Pallas kernel lacks, is held to the JAX
model's ``decode_attention(window=)`` on the cache gathered from the pages.
The head dims 80, 112 and 120 and groups of up to 16 q heads per kv head
are the kernels' padded instances and second query tile; head dim 80 runs
at G 1 (zamba2-2.7b's MHA) and G 2. The CUDA kernels
themselves are held against the plain versions on the card in
``tests/test_torch_kernels_gpu.py``. Tolerances: 2e-3 in fp32, 2e-2 in
bf16, as ``tests/test_kernels.py`` states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as _flash_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as _paged_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import attention as tattn

# copied from tests/test_kernels.py
FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, window, block_q, block_k
    (1, 128, 128, 4, 4, 64, 0, 64, 64),        # MHA, square
    (2, 128, 128, 8, 2, 32, 0, 32, 64),        # GQA 4:1
    (2, 64, 256, 4, 4, 64, 0, 64, 64),         # kv longer than q (chunked ctx)
    (1, 256, 256, 6, 2, 128, 0, 128, 128),     # MXU-aligned D
    (2, 128, 128, 4, 1, 64, 0, 64, 32),        # MQA
    (1, 256, 256, 4, 4, 64, 64, 64, 64),       # sliding window
    (1, 192, 192, 4, 2, 64, 32, 64, 64),       # window + ragged tiles
]
PAGED_CASES = [
    # B, KV, G, D, page, P, nblk
    (2, 2, 4, 64, 16, 16, 4),
    (3, 4, 1, 64, 16, 32, 6),       # MHA-style
    (1, 1, 8, 128, 16, 8, 8),       # MQA, deep table
    (4, 2, 2, 32, 16, 64, 3),
]
# the port's padded head dims (kimi-k2's 112, h2o-danube's 120) and groups
# past one query tile of the bf16 kernel (llama3-405b's 16)
PADDED_FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, window, block_q, block_k
    (1, 128, 128, 8, 2, 120, 0, 64, 64),       # D 120, GQA 4:1
    (1, 200, 200, 4, 2, 112, 64, 64, 64),      # D 112, window, ragged tiles
    (2, 160, 160, 4, 1, 120, 48, 32, 32),      # D 120, window, lens (160, 80)
    (1, 160, 160, 4, 4, 80, 0, 64, 64),        # D 80, MHA (G 1), ragged tile
    (2, 96, 96, 4, 2, 80, 0, 32, 32),          # D 80, G 2, lens (96, 48)
]
PADDED_PAGED_CASES = [
    # B, KV, G, D, page, P, nblk
    (2, 2, 16, 128, 16, 32, 5),     # G 16
    (2, 1, 9, 112, 16, 32, 4),      # G 9, D 112
    (3, 2, 4, 120, 16, 32, 3),      # D 120
    (2, 4, 1, 80, 16, 32, 4),       # D 80, G 1
    (3, 2, 2, 80, 16, 32, 3),       # D 80, G 2
]
# windowed decode: B, KV, G, D, nblk, tokens of each sequence, window; the
# kernel splits sequences into partitions of 256 tokens
WINDOW_PAGED_CASES = [
    (2, 2, 16, 128, 40, [600, 300], 100),   # edges inside partitions 1 and 0
    (2, 2, 3, 112, 40, [513, 40], 257),     # edge on a partition boundary;
                                            # a window past the sequence
    (1, 1, 4, 120, 40, [620], 108),         # edge on a boundary, D 120
    (3, 2, 9, 120, 24, [384, 17, 200], 1000),  # window past every sequence
]
# K1's non-causal mode with a scale of its own (the reference wrapper's
# ``causal=False, scale=``): Sq != Skv, lens < Skv, with and without a window
NONCAUSAL_CASES = [
    # B, Sq, Skv, H, KV, D, window, block_q, block_k, lens, scale
    (2, 64, 160, 4, 2, 64, 0, 32, 32, [130, 160], 0.07),
    (1, 96, 48, 4, 4, 32, 0, 32, 16, [40], 0.3),
    (2, 80, 200, 6, 2, 128, 24, 16, 40, [200, 90], 0.05),
    (1, 128, 128, 8, 2, 80, 40, 64, 64, [100], 0.1),
]
NONCAUSAL_ATOL = 1e-5
# jitted: one compile per shape instead of one per eager op
flash_attention_ref = jax.jit(_flash_ref, static_argnames=("window",))
noncausal_ref = jax.jit(_flash_ref, static_argnames=("causal", "window", "scale"))
paged_attention_ref = jax.jit(_paged_ref)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dtype):
    """The same numpy array as a JAX and a torch tensor of one dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(out_t, ref_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(ref_j, np.float32),
                               rtol=tol, atol=tol)


def _flash_inputs(case, seed):
    B, Sq, Skv, H, KV, D, window = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    lens = np.asarray([Skv] + [max(Skv // 2, 1)] * (B - 1), np.int32)
    return q, k, v, lens, window


def _paged_inputs(case, seed):
    B, KV, G, D, page, P, nblk = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    tables = rng.integers(0, P, size=(B, nblk)).astype(np.int32)
    lens = np.asarray([nblk * page - 1] + [page // 2] * (B - 1), np.int32)
    return q, kp, vp, tables, lens


# ------------------------------------------------------------ K1 on the CPU
ALL_FLASH = FLASH_CASES + PADDED_FLASH_CASES
ALL_PAGED = PAGED_CASES + PADDED_PAGED_CASES


@pytest.mark.parametrize("case", ALL_FLASH)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plain_vs_jax_ref(case, dtype):
    q, k, v, lens, window = _flash_inputs(case, ALL_FLASH.index(case))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    ref = flash_attention_ref(qj, kj, vj, jnp.asarray(lens), window=window)
    out = flash_ops.flash_attention(qt, kt, vt, torch.from_numpy(lens),
                                    window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[6],
                                  PADDED_FLASH_CASES[2], PADDED_FLASH_CASES[3],
                                  PADDED_FLASH_CASES[4]])
def test_flash_plain_vs_jax_interpret(case):
    """The Pallas kernel itself, in interpret mode (fp32)."""
    B, Sq, Skv, H, KV, D, window, bq, bk = case
    q, k, v, lens, _ = _flash_inputs(case, 100 + ALL_FLASH.index(case))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(lens), window=window, block_q=bq, block_k=bk,
                    interpret=True)
    out = flash_ops.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), window=window)
    _close(out, ref, 2e-3)


def _noncausal_inputs(case, seed):
    B, Sq, Skv, H, KV, D, window, bq, bk, lens, scale = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    return q, k, v, np.asarray(lens, np.int32), window, scale


@pytest.mark.parametrize("case", NONCAUSAL_CASES)
def test_flash_noncausal_plain_vs_jax_ref(case):
    """``causal=False`` with a scale: every key below lens (within the
    window of the query's position) against ``flash_attention_ref``, fp32."""
    q, k, v, lens, window, scale = _noncausal_inputs(case, 200 + NONCAUSAL_CASES.index(case))
    ref = noncausal_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lens), causal=False, window=window, scale=scale)
    out = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(lens),
                                    causal=False, window=window, scale=scale)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=NONCAUSAL_ATOL)
    # the mode changes the result: a causal run of the same inputs differs
    causal = flash_ops.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), window=window, scale=scale)
    assert float((causal - out).abs().max()) > 0.1


@pytest.mark.parametrize("case", NONCAUSAL_CASES)
def test_flash_noncausal_plain_vs_jax_interpret(case):
    """The Pallas kernel itself, in interpret mode, with ``causal=False``
    and the scale (fp32)."""
    B, Sq, Skv, H, KV, D, window, bq, bk, _, _ = case
    q, k, v, lens, window, scale = _noncausal_inputs(case, 300 + NONCAUSAL_CASES.index(case))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(lens), causal=False, window=window, scale=scale,
                    block_q=bq, block_k=bk, interpret=True)
    out = flash_ops.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), causal=False, window=window, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=NONCAUSAL_ATOL)


def test_flash_noncausal_meta_books_its_pairs():
    """On meta the wrapper books the pairs the non-causal mode reads:
    every key for every query, or those inside each query's window."""
    from repro_torch.analysis.counter import OpCounter
    B, Sq, Skv, H, KV, D = 1, 6, 10, 2, 1, 32
    q = torch.empty((B, Sq, H, D), device="meta")
    k = torch.empty((B, Skv, KV, D), device="meta")
    for window, pairs in ((0, Sq * Skv), (3, sum(Skv - max(0, i - 2) for i in range(Sq)))):
        assert flash_ops.causal_pairs(Sq, Skv, window, causal=False) == pairs
        with OpCounter() as c:
            flash_ops.flash_attention(q, k, k, causal=False, window=window)
        assert c.flops == 4.0 * B * H * pairs * D


@pytest.mark.parametrize("offset,window,kv_len", [(0, 0, 96), (32, 0, 80),
                                                  (32, 24, 96)])
def test_flash_prefill_matches_jax(offset, window, kv_len):
    """Model-level prefill attention with chunk offsets, kv lengths and a
    window, against ``repro.models.attention.flash_prefill``."""
    rng = np.random.default_rng(offset + window)
    B, Sq, Skv, H, KV, D = 2, 64, 96, 8, 2, 32
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    pos = (offset + np.arange(Sq, dtype=np.int32))[None]
    kv_lens = np.asarray([kv_len, Skv], np.int32)
    ref = jattn.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_positions=jnp.asarray(pos),
                              kv_lens=jnp.asarray(kv_lens), window=window,
                              block_k=32)
    out = tattn.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              q_positions=torch.from_numpy(pos),
                              kv_lens=torch.from_numpy(kv_lens), window=window)
    _close(out, ref, 2e-3)


def test_flash_kernel_matches_model_prefill():
    """The wrapper agrees with the model-level function it replaces, as
    ``tests/test_kernels.py::test_flash_matches_model_flash_jnp``."""
    rng = np.random.default_rng(7)
    B, S, H, KV, D = 2, 128, 8, 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    pos = torch.arange(S, dtype=torch.int32)[None]
    np.testing.assert_allclose(
        flash_ops.flash_attention(q, k, v).numpy(),
        tattn.flash_prefill(q, k, v, q_positions=pos).numpy(),
        rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------ K2 on the CPU
@pytest.mark.parametrize("case", ALL_PAGED)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_plain_vs_jax_ref(case, dtype):
    q, kp, vp, tables, lens = _paged_inputs(case, ALL_PAGED.index(case))
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, kp, vp))
    ref = paged_attention_ref(qj, kj, vj, jnp.asarray(tables),
                              jnp.asarray(lens))
    out = paged_ops.paged_attention(qt, kt, vt, torch.from_numpy(tables),
                                    torch.from_numpy(lens))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("case", [PAGED_CASES[0], PAGED_CASES[3],
                                  PADDED_PAGED_CASES[3], PADDED_PAGED_CASES[4]])
def test_paged_plain_vs_jax_interpret(case):
    """The Pallas kernel itself, in interpret mode (fp32), through its
    (B,H,D) wrapper."""
    q, kp, vp, tables, lens = _paged_inputs(case, 200 + ALL_PAGED.index(case))
    B, KV, G, D = q.shape
    ref = jax_paged(jnp.asarray(q.reshape(B, KV * G, D)), jnp.asarray(kp),
                    jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(lens),
                    interpret=True)
    out = paged_ops.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))
    _close(out.reshape(B, KV * G, D), ref, 2e-3)


@pytest.mark.parametrize("case", WINDOW_PAGED_CASES)
def test_paged_plain_window_vs_jax_decode_attention(case):
    """The window of ``repro.models.attention.decode_attention`` (fp32) on
    the dense cache gathered from shuffled pages, and that the window
    changes the output wherever it binds."""
    B, KV, G, D, nblk, tokens, window = case
    page = 16
    rng = np.random.default_rng(500 + WINDOW_PAGED_CASES.index(case))
    P = B * nblk + 8
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    tables = rng.permutation(P)[:B * nblk].reshape(B, nblk).astype(np.int32)
    lens = np.asarray(tokens, np.int32) - 1
    kc, vc = (x[tables].reshape(B, nblk * page, KV, D) for x in (kp, vp))
    ref = jattn.decode_attention(jnp.asarray(q.reshape(B, 1, KV * G, D)),
                                 jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.asarray(lens), window=window)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    out = paged_ops.paged_attention(*args, window=window)
    _close(out.reshape(B, 1, KV * G, D), ref, 2e-3)
    full = paged_ops.paged_attention(*args)
    binds = torch.from_numpy(lens + 1 > window)
    differs = (out - full).abs().amax(dim=(1, 2, 3)) > 1e-3
    assert torch.equal(differs, binds)


def test_paged_matches_dense_decode():
    """Identity page layout: the paged wrapper equals the port's dense
    ``decode_attention``, which equals the JAX one."""
    B, KV, G, D, page, nblk = 2, 2, 2, 32, 16, 4
    H, S = KV * G, page * nblk
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    lens = np.asarray([S - 1, 20], np.int32)
    dense = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)))
    jdense = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)))
    _close(dense, jdense, 2e-3)
    tables = np.arange(B * nblk, dtype=np.int32).reshape(B, nblk)
    paged = paged_ops.paged_attention(
        torch.from_numpy(q).view(B, KV, G, D),
        torch.from_numpy(kc).reshape(B * nblk, page, KV, D),
        torch.from_numpy(vc).reshape(B * nblk, page, KV, D),
        torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_allclose(paged.view(B, 1, H, D).numpy(), dense.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_model_windowed_decode_matches_jax():
    """The port's dense ``decode_attention`` with a window, as the JAX one."""
    B, KV, G, D, S, window = 2, 2, 4, 120, 80, 24
    rng = np.random.default_rng(13)
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray([S - 1, 20], np.int32)
    out = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc, lens)),
                                 window=window)
    ref = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                                 window=window)
    _close(out, ref, 2e-3)


def test_cpu_calls_launch_nothing():
    flash_before = flash_ops.KERNEL.launches
    paged_before = paged_ops.KERNEL.launches
    q, k, v, lens, _ = _flash_inputs(FLASH_CASES[0], 0)
    flash_ops.flash_attention(*map(torch.from_numpy, (q, k, v, lens)))
    paged_ops.paged_attention(*map(torch.from_numpy,
                                   _paged_inputs(PAGED_CASES[0], 0)))
    assert flash_ops.KERNEL.launches == flash_before
    assert paged_ops.KERNEL.launches == paged_before


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU never takes the plain version. On
    the meta device (the dry-run's) each wrapper books its kernel's count
    with the active op counter and returns an empty meta result: no
    launch, and none of the plain version's products (which the counter
    would book as ``aten.bmm``)."""
    from repro_torch.analysis.counter import OpCounter
    q = torch.empty((1, 16, 4, 64), device="meta")
    k = torch.empty((1, 16, 2, 64), device="meta")
    qd = torch.empty((1, 2, 2, 64), device="meta")
    pages = torch.empty((4, 16, 2, 64), device="meta")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    counts = [kern.launches for kern in (flash_ops.KERNEL, paged_ops.KERNEL,
                                         paged_ops.PARTIALS, paged_ops.MERGE)]
    with OpCounter() as c:
        out = flash_ops.flash_attention(q, k, k)
        dec = paged_ops.paged_attention(qd, pages, pages, tables, lens)
        acc, ml = paged_ops.paged_attention_partials(qd, pages, pages, tables, lens)
        merged = paged_ops.paged_merge(acc, ml, qd.dtype)
    assert [kern.launches for kern in (flash_ops.KERNEL, paged_ops.KERNEL,
                                       paged_ops.PARTIALS, paged_ops.MERGE)] == counts
    assert all(t.device.type == "meta" for t in (out, dec, acc, ml, merged))
    assert out.shape == q.shape and dec.shape == merged.shape == qd.shape
    assert set(c.flops_by_op) == {"flash_attention", "paged_attention",
                                  "paged_attention_partials"}
    # 136 causal pairs of 16 positions, 4 heads, 4 * D operations a pair;
    # 2 pages of keys, 2 kv heads of 2 queries
    assert c.flops_by_op["flash_attention"] == 4 * 64 * 136 * 4
    assert c.flops_by_op["paged_attention"] == 4 * 64 * 32 * 2 * 2
