"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip on a machine without a CUDA card, where a kernel
cannot run. This file imports no JAX, so it runs on a card machine without
it (see README.md). Tolerances: 2e-3 in fp32, 2e-2 in bf16, elementwise;
over the whole output, |out - ref|_2 / |ref|_2 at most 1e-3 in fp32 and
1e-2 in bf16, so a dropped key tile or partition fails where its rows'
values are small.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops

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
    (1, 1000, 1000, 24, 8, 128, 0, 0, 0),      # llama3.2-3b prompt, ragged
    # edges of the bf16 tensor-core instance (128-row q tiles, 128-key
    # tiles); the last field, where present, is lens
    (1, 137, 137, 24, 8, 128, 0, 0, 0),        # served prompt, one partial q tile
    (1, 200, 200, 4, 2, 32, 0, 0, 0),          # D 32: 64-byte swizzle
    (2, 200, 200, 4, 2, 64, 0, 0, 0),          # D 64, ragged, lens (200, 100)
    (2, 100, 300, 4, 4, 128, 0, 0, 0),         # Skv > Sq
    (1, 300, 300, 4, 2, 128, 0, 0, 0, [170]),  # lens < Skv, mid-tile
    (2, 130, 130, 2, 2, 64, 0, 0, 0, [0, 65]),  # no valid key: zeros
    (1, 1, 1, 4, 2, 64, 0, 0, 0),              # one token
    (1, 333, 333, 4, 2, 128, 100, 0, 0),       # window, ragged
    (1, 260, 260, 4, 1, 32, 48, 0, 0, [250]),  # window, D 32, lens < Skv
    # the padded head dims (TMA zero-fills columns D..127 in bf16)
    (1, 300, 300, 8, 2, 112, 0, 0, 0),         # D 112, ragged
    (2, 333, 333, 4, 1, 120, 0, 0, 0),         # D 120, lens (333, 166)
    (1, 400, 400, 8, 8, 112, 100, 0, 0, [390]),  # D 112, window, lens < Skv
    (1, 300, 300, 4, 2, 120, 130, 0, 0),       # D 120, window
    (1, 1000, 1000, 40, 8, 128, 0, 0, 0),      # qwen3-14b prompt
    (1, 1000, 1000, 64, 8, 112, 0, 0, 0),      # kimi-k2 prompt
    (1, 600, 600, 128, 8, 128, 0, 0, 0),       # llama3-405b heads
    (1, 5000, 5000, 32, 8, 120, 4096, 0, 0),   # h2o-danube prompt, window binds
    # head dim 80 (zamba2-2.7b's shared attention: 32 heads, MHA)
    (1, 1000, 1000, 32, 32, 80, 0, 0, 0),      # zamba2 prompt, G 1
    (2, 300, 300, 4, 2, 80, 0, 0, 0),          # G 2, lens (300, 150)
    (1, 333, 333, 4, 4, 80, 100, 0, 0, [250]),  # window, lens < Skv
    # the vlm and audio backbones: musicgen-medium (MHA, 24 heads of 64)
    # and internvl2-76b (64 / 8 heads of 128), the latter also at its 256
    # prefix embeddings plus 200 text tokens
    (1, 1000, 1000, 24, 24, 64, 0, 0, 0),      # musicgen prompt, G 1
    (1, 1000, 1000, 64, 8, 128, 0, 0, 0),      # internvl2 prompt, G 8
    (1, 456, 456, 64, 8, 128, 0, 0, 0),        # internvl2 prefix + text
    # one rank of zamba2-2.7b's shared block at tp 2: 16 q / 16 kv heads of 80
    (1, 1000, 1000, 16, 16, 80, 0, 0, 0),
    # edges of the fp32 instance (64-row q tiles, 64-key tiles; v rows of
    # D rounded up to 16, a lane's columns in pieces of 4, 2 and 1)
    (1, 65, 65, 4, 2, 128, 0, 0, 0),           # one row and one key past a tile
    (2, 191, 191, 8, 2, 120, 0, 0, 0),         # ragged, D 120, lens (191, 95) mid-tile
    (1, 250, 250, 4, 4, 112, 40, 0, 0, [201]),  # window edge inside a tile, D 112
    (1, 129, 129, 6, 3, 80, 0, 0, 0, [0]),     # lens 0: zeros, D 80
    (2, 64, 64, 4, 2, 32, 0, 0, 0, [64, 0]),   # one whole tile, lens 0, D 32
    (1, 200, 200, 8, 2, 128, 63, 0, 0, [170]),  # window 63, lens mid-tile
]
PAGED_CASES = [
    # B, KV, G, D, page, P, nblk[, tokens of each sequence[, window]]
    (2, 2, 4, 64, 16, 16, 4),
    (3, 4, 1, 64, 16, 32, 6),       # MHA-style
    (1, 1, 8, 128, 16, 8, 8),       # MQA, deep table
    (4, 2, 2, 32, 16, 64, 3),
    (16, 8, 3, 128, 16, 1024, 64),  # llama3.2-3b decode batch
    # partition edges of the split kernel (16 pages = 256 tokens); the last
    # field is each sequence's token count, tables padded past its pages
    (5, 2, 3, 128, 16, 512, 128, [1, 255, 256, 257, 2048]),
    (1, 8, 3, 128, 16, 256, 128, [2048]),         # B=1, one long sequence
    (3, 2, 1, 64, 16, 64, 40, [300, 17, 640]),    # G 1
    (2, 1, 8, 128, 16, 64, 36, [513, 16]),        # G 8
    (2, 4, 8, 32, 16, 64, 20, [1, 320]),          # G 8, D 32
    # the padded head dims, the second query tile (G 9..16) and the window;
    # a partition is 256 tokens
    (3, 8, 8, 112, 16, 256, 80, [1280, 17, 700]),     # kimi-k2: D 112, G 8
    (3, 8, 4, 120, 16, 256, 80, [1280, 255, 600]),    # h2o-danube: D 120
    (2, 8, 16, 128, 16, 256, 80, [1280, 300]),        # llama3-405b: G 16
    (2, 2, 9, 128, 16, 64, 40, [513, 40]),            # G 9: half a second tile
    (2, 2, 5, 128, 16, 64, 40, [600, 100]),           # qwen3-14b: G 5
    (2, 2, 16, 112, 16, 128, 40, [600, 300], 100),    # edges inside partitions
    (2, 2, 4, 120, 16, 128, 40, [513, 40], 257),      # edge on a partition
                                                      # boundary; window > seq
    (1, 1, 9, 120, 16, 64, 40, [620], 108),           # edge on a boundary
    (3, 8, 4, 120, 16, 1024, 400, [6400, 4096, 4500], 4096),  # danube decode
    (2, 2, 3, 64, 16, 64, 40, [384, 17], 1000),       # window past every sequence
    # head dim 80 (zamba2-2.7b's decode: 32 kv heads, G 1)
    (16, 32, 1, 80, 16, 1024, 64),                    # zamba2 decode batch
    (4, 32, 1, 80, 16, 512, 80, [1280, 256, 257, 17]),  # partition edges, G 1
    (3, 2, 2, 80, 16, 64, 40, [513, 40, 256]),        # G 2
    (2, 2, 1, 80, 16, 64, 40, [600, 300], 100),       # window, G 1
    # musicgen-medium's decode (24 kv heads of 64, G 1) and internvl2-76b's
    # (8 kv heads of 128, G 8), at the batch and contexts they serve
    (16, 24, 1, 64, 16, 1400, 80, [1280, 128, 256, 257, 700, 1000, 17,
                                   513, 900, 1100, 333, 640, 768, 1024,
                                   200, 999]),
    (16, 8, 8, 128, 16, 1400, 80, [1280, 128, 256, 257, 700, 1000, 17,
                                   513, 900, 1100, 333, 640, 768, 1024,
                                   200, 999]),
    # one rank of zamba2-2.7b's decode at tp 2: 16 kv heads of 80, G 1, at
    # contexts of 128-1280 tokens
    (16, 16, 1, 80, 16, 1400, 80, [1280, 128, 256, 257, 700, 1000, 17, 500,
                                   900, 1100, 300, 64, 1200, 800, 200, 999]),
]
DTYPES = {"float32": (torch.float32, 2e-3), "bfloat16": (torch.bfloat16, 2e-2)}
REL_RMS = {"float32": 1e-3, "bfloat16": 1e-2}


def _assert_close(out, ref, tol, rel_rms):
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    assert np.linalg.norm(out - ref) <= rel_rms * np.linalg.norm(ref)


def _flash_inputs(case, seed):
    B, Sq, Skv, H, KV, D, window = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    if len(case) > 9:
        lens = np.asarray(case[9], np.int32)
    else:
        lens = np.asarray([Skv] + [max(Skv // 2, 1)] * (B - 1), np.int32)
    return q, k, v, lens, window


def _paged_inputs(case, seed):
    """q, pages, tables, lens and the window (0: none)."""
    B, KV, G, D, page, P, nblk = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, D)).astype(np.float32)
    tables = rng.integers(0, P, size=(B, nblk)).astype(np.int32)
    if len(case) > 7:
        lens = np.asarray(case[7], np.int32) - 1
    else:
        lens = np.asarray([nblk * page - 1] + [page // 2] * (B - 1), np.int32)
    window = case[8] if len(case) > 8 else 0
    return q, kp, vp, tables, lens, window


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_vs_plain(cuda, case, dtype):
    q, k, v, lens, window = _flash_inputs(case, 300 + FLASH_CASES.index(case))
    tdt, tol = DTYPES[dtype]
    qt, kt, vt = (torch.from_numpy(a).to(cuda, tdt) for a in (q, k, v))
    lt = torch.from_numpy(lens).to(cuda)
    before = flash_ops.KERNEL.launches
    out = flash_ops.flash_attention(qt, kt, vt, lt, window=window)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL.launches == before + 1
    ref = flash_ops.flash_attention_plain(qt, kt, vt, lt, window=window)
    _assert_close(out, ref, tol, REL_RMS[dtype])


# K1's non-causal instances with a scale of their own: (B, Sq, Skv, H,
# KV, D, window, lens, scale); Sq != Skv, lens < Skv, tiles cut mid-way
NONCAUSAL_CASES = [
    (2, 200, 333, 8, 2, 64, 0, [333, 170], 0.09),
    (1, 300, 137, 4, 4, 80, 0, [100], 0.2),
    (2, 130, 500, 8, 2, 128, 0, [450, 257], 0.06),
    (1, 257, 400, 4, 2, 128, 100, [390], 0.1),
    (2, 100, 260, 8, 8, 80, 48, [260, 129], 0.15),
    (1, 64, 1000, 24, 8, 128, 0, [1000], 128 ** -0.5),
    (1, 1000, 1000, 24, 8, 128, 0, [1000], 128 ** -0.5),
    (2, 130, 130, 2, 2, 64, 0, [0, 65], 0.125),    # no valid key: zeros
    # edges of the fp32 instance's 64-row and 64-key tiles
    (1, 65, 129, 4, 2, 128, 0, [100], 0.1),          # ragged q, lens mid-tile
    (2, 191, 200, 8, 2, 120, 40, [200, 77], 0.08),   # window edge inside a tile
    (1, 64, 64, 4, 4, 112, 0, [0], 0.125),           # lens 0: zeros
    (2, 130, 65, 4, 1, 80, 0, [65, 1], 0.2),         # one key past a tile, lens 1
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", NONCAUSAL_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_noncausal_kernel_vs_plain(cuda, case, dtype):
    """``causal=False`` with a non-default scale: the non-causal instance
    (counted by ``NONCAUSAL``, never by the causal ``KERNEL``) against the
    plain version on the same inputs."""
    B, Sq, Skv, H, KV, D, window, lens, scale = case
    rng = np.random.default_rng(700 + NONCAUSAL_CASES.index(case))
    tdt, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, tdt)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (flash_ops.KERNEL.launches, flash_ops.NONCAUSAL.launches)
    out = flash_ops.flash_attention(q, k, v, lt, causal=False, window=window, scale=scale)
    torch.cuda.synchronize()
    assert (flash_ops.KERNEL.launches, flash_ops.NONCAUSAL.launches) == \
        (before[0], before[1] + 1)
    ref = flash_ops.flash_attention_plain(q, k, v, lt, causal=False, window=window,
                                          scale=scale)
    _assert_close(out, ref, tol, REL_RMS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_kernel_vs_plain(cuda, case, dtype):
    q, kp, vp, tables, lens, window = _paged_inputs(case, 400 + PAGED_CASES.index(case))
    tdt, tol = DTYPES[dtype]
    qt, kt, vt = (torch.from_numpy(a).to(cuda, tdt) for a in (q, kp, vp))
    tt, lt = torch.from_numpy(tables).to(cuda), torch.from_numpy(lens).to(cuda)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(qt, kt, vt, tt, lt, window=window)
    torch.cuda.synchronize()
    assert paged_ops.KERNEL.launches == before + 1
    ref = paged_ops.paged_attention_plain(qt, kt, vt, tt, lt, window=window)
    _assert_close(out, ref, tol, REL_RMS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("D,G", [(96, 4), (128, 17), (130, 4)])
def test_paged_refuses_what_the_kernel_lacks(cuda, D, G):
    """A head dim without an instance, or more than 16 q heads per kv head,
    raises before any launch."""
    q = torch.zeros((1, 2, G, D), device=cuda)
    pages = torch.zeros((4, 16, 2, D), device=cuda)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    before = paged_ops.KERNEL.launches
    with pytest.raises(ValueError, match="head dim|group"):
        paged_ops.paged_attention(q, pages, pages, tables, lens)
    assert paged_ops.KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("D", [96, 130])
def test_flash_refuses_head_dims_without_an_instance(cuda, D):
    q = torch.zeros((1, 16, 4, D), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16, device=cuda)
    before = flash_ops.KERNEL.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(q, k, k)
    assert flash_ops.KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_bf16_misaligned_raises(cuda, dtype):
    """Both instances (bf16 and, since its TMA design, fp32) read through
    TMA, which needs 16-byte aligned bases: the wrapper refuses a q that
    starts one element (2 or 4 bytes) into its storage."""
    tdt = DTYPES[dtype][0]
    shape = (1, 64, 2, 64)
    n = int(np.prod(shape))
    q = torch.zeros(n + 1, dtype=tdt, device=cuda)[1:].view(shape)
    k = torch.zeros(shape, dtype=tdt, device=cuda)
    before = flash_ops.KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops.flash_attention(q, k, k)
    assert flash_ops.KERNEL.launches == before


# (B, KV, G, D, blocks of the table, newest token's index per sequence,
# window): K2's partials over two halves of each table, merged
SPLIT_CASES = [
    (2, 4, 1, 64, 40, [639, 300], 0),
    (2, 4, 3, 80, 40, [639, 200], 0),
    (1, 8, 8, 120, 64, [1000], 0),
    (2, 2, 16, 128, 48, [767, 500], 0),
    (2, 4, 4, 128, 40, [639, 330], 100),
    (1, 32, 1, 80, 64, [1023], 256),
    (2, 8, 12, 112, 36, [575, 280], 300),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_partials_merged_equal_the_one_call(cuda, case, dtype):
    """Each half of the table (the positions one rank of a sequence-split
    cache holds) through the partials kernel with lens counted from the
    half's start, the partitions concatenated and merged by the merge
    kernel: equal to ``paged_attention`` (the plain version and the kernel)
    on the whole table. A half past the newest token, or left of the
    window, adds nothing."""
    B, KV, G, D, nblk, newest, window = case
    rng = np.random.default_rng(500 + SPLIT_CASES.index(case))
    P = B * nblk
    tdt, tol = DTYPES[dtype]
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, tdt)
                 for s in ((B, KV, G, D), (P, 16, KV, D), (P, 16, KV, D)))
    tables = torch.from_numpy(rng.permutation(P).reshape(B, nblk).astype(np.int32)).to(cuda)
    lens = torch.tensor(newest, dtype=torch.int32, device=cuda)
    half = nblk // 2
    counts = (paged_ops.PARTIALS.launches, paged_ops.MERGE.launches)
    parts = [paged_ops.paged_attention_partials(
        q, kp, vp, tables[:, i * half:(i + 1) * half].contiguous(),
        lens - i * half * 16, window=window) for i in range(2)]
    acc = torch.cat([a for a, _ in parts], dim=2)
    ml = torch.cat([m for _, m in parts], dim=2)
    out = paged_ops.paged_merge(acc, ml, tdt)
    torch.cuda.synchronize()
    assert (paged_ops.PARTIALS.launches, paged_ops.MERGE.launches) == \
        (counts[0] + 2, counts[1] + 1)
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window)
    _assert_close(out, ref, tol, REL_RMS[dtype])
    _assert_close(out, paged_ops.paged_attention(q, kp, vp, tables, lens, window=window),
                  tol, REL_RMS[dtype])
    # the plain halves merged by the plain merge: the kernel's partials'
    # layout, and a partition no block writes holds (0, (NEG_INF, 0))
    plain = [paged_ops.paged_attention_partials_plain(
        q, kp, vp, tables[:, i * half:(i + 1) * half], lens - i * half * 16,
        window=window) for i in range(2)]
    _assert_close(paged_ops.paged_merge_plain(
        torch.cat([a for a, _ in plain], 2), torch.cat([m for _, m in plain], 2), tdt),
        ref, tol, REL_RMS[dtype])
    assert acc.shape == torch.cat([a for a, _ in plain], 2).shape


# ------------------------------------------------ pages of another dtype
# K2 over a cache of the reference's kv_cache_dtype: (pages, q) dtypes
Q8_PAIRS = [("float8_e4m3fn", "bfloat16"), ("float8_e4m3fn", "float32"),
            ("int8", "bfloat16"), ("int8", "float32"), ("bfloat16", "float32")]
# B, KV, G, D, page, P, nblk[, tokens of each sequence[, window]]: the
# main paths' shapes (llama3.2-3b's decode batch, h2o-danube's D 120 with
# its window, llama3-405b's G 16, zamba2's D 80 at G 1) and the edges
Q8_CASES = [
    (16, 8, 3, 128, 16, 1024, 64),                            # llama3.2-3b
    (5, 2, 3, 128, 16, 512, 128, [1, 255, 256, 257, 2048]),   # partition edges
    (3, 8, 4, 120, 16, 256, 80, [1280, 255, 600], 257),       # h2o-danube, window
    (2, 8, 16, 128, 16, 256, 80, [1280, 300]),                # llama3-405b: G 16
    (4, 32, 1, 80, 16, 512, 80, [1280, 256, 257, 17]),        # zamba2: D 80, G 1
    (2, 2, 9, 112, 16, 64, 40, [513, 40], 100),               # G 9, D 112, window
    (2, 4, 8, 32, 16, 64, 20, [1, 320]),                      # D 32
    (3, 4, 1, 64, 16, 32, 6),                                 # D 64
]
# the default mode: the same function as the plain version, fp32 sums in
# another order (1e-4 of unit values), the output's rounding to q's dtype
# (2^-8 of it in bf16) and ``weight_slack`` (a weight near a rounding
# boundary of the pages' dtype may round to the other neighbour); the
# upcast mode: the existing K2 tolerances times the values' scale (the
# kernel rounds a bf16 q's q*scale and weights to bf16, keeps an fp32 q's
# as three bf16 terms)
Q8_ATOL = 1e-4
# int8 pages also under q times these, where q*scale truncates to non-zero
# integers and the output is not zeros: at x12 most rows' largest weight
# lies in [0.5, 1) (truncated to 0, where rounding to nearest gives 1), at
# x40 most rows' is exactly 1 (the output is that key's v)
INT8_QX = (12.0, 40.0)
# (pair, qx): the upcast mode truncates nothing, so it runs at x1 only
Q8_RUNS = [(p, 1.0) for p in Q8_PAIRS] + [(p, x) for p in Q8_PAIRS if p[0] == "int8"
                                          for x in INT8_QX]
Q8_IDS = [f"{'/'.join(p)}" + (f"-qx{x:g}" if x != 1 else "") for p, x in Q8_RUNS]
Q8_MODES = [(p, x, m) for p, x in Q8_RUNS for m in ("default", "upcast")
            if x == 1.0 or m == "default"]


def _q8_inputs(case, pages, qdt, seed, cuda, qx=1.0):
    from repro_torch.models.cache_dtype import to_cache_dtype
    q, kp, vp, tables, lens, window = _paged_inputs(case, seed)
    scale = 3.0 if pages == torch.int8 else 1.0   # small integers in int8
    kp, vp = (to_cache_dtype(torch.from_numpy(a).to(cuda) * scale, pages) for a in (kp, vp))
    return (torch.from_numpy(q * qx).to(cuda, qdt), kp, vp,
            torch.from_numpy(tables).to(cuda), torch.from_numpy(lens).to(cuda), window)


def _int8_scores(q, kp, tables, lens, window, ref, slack, qx):
    """With q times ``qx`` > 1 over int8 pages the plain output must tell a
    kernel that truncates from one that writes zeros or rounds to nearest:
    rows held exactly (no slack) whose largest weight is 1 (x40), or lies
    in [0.5, 1) (x12)."""
    from repro_torch.kernels.paged_attention.ref import decode_weights
    if qx == 1.0:
        return
    top = decode_weights(q, kp, tables, lens, window).amax(dim=-1)
    exact = slack.amax(dim=-1) == 0
    nonzero = ref.float().abs().amax(dim=-1) > 0
    if qx == INT8_QX[0]:
        assert bool(((top >= 0.5) & (top < 1) & exact).any())
    else:
        assert bool((nonzero & exact).any())


def _hold_q8(out, ref, q, slack, vp, upcast, ulp=False):
    """``ulp``: the outputs' rounding to a bf16 q's dtype as one whole ulp
    (2^-7 of the value at most) where 2^-8 takes half: a weight within the
    slack can move one side's fp32 sum across a rounding point, and the
    two bf16 values then differ by the slack and one ulp (the one-call
    kernel did at the split test's llama3-405b input too)."""
    out, ref = out.float(), ref.float()
    assert bool(torch.isfinite(out).all())
    v_scale = float(vp.float().std())
    if upcast:
        tol = DTYPES[str(q.dtype)[6:]][1] * v_scale
        bound = tol + tol * ref.abs()
    else:
        rel = (2.0 ** -7 if ulp else 2.0 ** -8) if q.dtype == torch.bfloat16 else 1e-6
        bound = Q8_ATOL * v_scale + rel * ref.abs() + slack
    assert bool(((out - ref).abs() <= bound).all()), float(((out - ref).abs() - bound).max())
    rel_rms = REL_RMS[str(q.dtype)[6:]]
    assert float((out - ref).norm()) <= rel_rms * float(ref.norm()) + float(slack.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("case", Q8_CASES)
@pytest.mark.parametrize("pair,qx,mode", Q8_MODES,
                         ids=[f"{'/'.join(p)}{f'-qx{x:g}' if x != 1 else ''}-{m}"
                              for p, x, m in Q8_MODES])
def test_paged_other_page_dtype_vs_plain(cuda, pair, qx, mode, case):
    """The default mode's cluster or the upcast mode's design against the
    plain version; one launch of its counter a call, none of the same-dtype
    kernel's."""
    from repro_torch.kernels.paged_attention.ref import weight_slack
    pages, qdt = (getattr(torch, n) for n in pair)
    upcast = mode == "upcast"
    q, kp, vp, tables, lens, window = _q8_inputs(case, pages, qdt,
                                                 700 + Q8_CASES.index(case), cuda, qx)
    counter = paged_ops.UPCAST if upcast else paged_ops.CVT
    before = (counter.launches, paged_ops.KERNEL.launches)
    out = paged_ops.paged_attention(q, kp, vp, tables, lens, window=window, upcast=upcast)
    torch.cuda.synchronize()
    assert (counter.launches, paged_ops.KERNEL.launches) == (before[0] + 1, before[1])
    if not upcast:   # every case here fits the one-launch design
        assert paged_ops.cvt_design(tables.shape[1], q.shape[2], window, q.shape[3],
                                    q.shape[1], kp.element_size()) == "cluster"
    assert out.dtype == qdt
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window,
                                          upcast=upcast)
    slack = weight_slack(q, kp, vp, tables, lens, window=window, upcast=upcast)
    if not upcast:
        _int8_scores(q, kp, tables, lens, window, ref, slack, qx)
    _hold_q8(out, ref, q, slack, vp, upcast)


# the split passes' (m, l) and scores against their plain versions: fp32
# sums of exact products in another order, within this share of the
# scores' scale; l (ex2.approx within 2^-21 a term) within this share of
# itself
SPLIT_ML_TOL, SPLIT_L_RTOL = 1e-4, 1e-3
SPLIT_COUNTERS = ("SHARE_STATS", "SHARE_VALUES", "SUM", "CVT")


def _split_counts():
    return {k: getattr(paged_ops, k).launches for k in SPLIT_COUNTERS}


def _run_split(q, kp, vp, shares, window):
    """Pass 1 on each share, the (m, l) gathered, pass 2 on each, the sums
    added: (out, [(ml, scores)], the gathered ml, [sum])."""
    passes = [paged_ops.paged_attention_stats(q, kp, t, l, window=window) for t, l in shares]
    ml = torch.cat([m for m, _ in passes], dim=2)
    parts = [paged_ops.paged_attention_values(q, kp, vp, t, l, ml, sc, window=window)
             for (t, l), (_, sc) in zip(shares, passes)]
    return paged_ops.paged_sum(torch.cat(parts, dim=2), q.dtype), passes, ml, parts


def _hold_split_passes(q, kp, vp, shares, window, passes, ml, parts, slack):
    """Each share's pass 1 against its plain version (the (m, l) where a
    key counts, (NEG_INF, 0) exactly where none does, the scores where a
    key counts) and its pass 2 against the plain pass 2 on the kernel's
    gathered (m, l) and the plain scores (zeros exactly where no key
    counts)."""
    from repro_torch.kernels.paged_attention.ref import NEG_INF
    for (t, l), (m, sc), part in zip(shares, passes, parts):
        m_p, sc_p = paged_ops.paged_attention_stats_plain(q, kp, t, l, window=window)
        counts = m_p[..., 1] > 0
        assert bool((m[..., 0][~counts] == NEG_INF).all())
        assert bool((m[..., 1][~counts] == 0).all())
        assert bool((part.transpose(2, 3)[~counts.transpose(2, 3)] == 0).all())
        valid = sc_p > NEG_INF / 2
        if not bool(valid.any()):
            continue
        scale = float(sc_p[valid].abs().max()) + 1.0
        assert float((sc - sc_p)[valid].abs().max()) <= SPLIT_ML_TOL * scale
        assert float((m[..., 0] - m_p[..., 0])[counts].abs().max()) <= SPLIT_ML_TOL * scale
        assert float(((m[..., 1] - m_p[..., 1]) / m_p[..., 1])[counts].abs().max()) \
            <= SPLIT_L_RTOL
        want = paged_ops.paged_attention_values_plain(q, kp, vp, t, l, ml, sc_p,
                                                      window=window)
        _hold_q8(part[:, :, 0], want[:, :, 0], q, slack, vp, False)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("pair,qx", Q8_RUNS, ids=Q8_IDS)
def test_paged_other_page_dtype_split_over_two_halves(cuda, pair, qx, case):
    """Each half of the table as a rank's share: pass 1 of both halves (the
    split cluster design: its scores and one (m, l) a share), the (m, l)
    gathered, pass 2 of both (which merges them), the sums added: two
    launches of each pass and one of the sum, no other K2 launch;
    against the one-call kernel and the plain version, and each pass
    against its plain version. The upcast mode's partials merged by the
    same-dtype merge kernel likewise."""
    from repro_torch.kernels.paged_attention.ref import weight_slack
    B, KV, G, D, nblk, newest, window = case
    pages, qdt = (getattr(torch, n) for n in pair)
    rng = np.random.default_rng(900 + SPLIT_CASES.index(case))
    P = B * nblk
    from repro_torch.models.cache_dtype import to_cache_dtype
    scale = 3.0 if pages == torch.int8 else 1.0
    q = torch.from_numpy(rng.standard_normal((B, KV, G, D)).astype(np.float32) * qx).to(
        cuda, qdt)
    kp, vp = (to_cache_dtype(torch.from_numpy(rng.standard_normal((P, 16, KV, D)).astype(
        np.float32)).to(cuda) * scale, pages) for _ in range(2))
    tables = torch.from_numpy(rng.permutation(P).reshape(B, nblk).astype(np.int32)).to(cuda)
    lens = torch.tensor(newest, dtype=torch.int32, device=cuda)
    half = nblk // 2
    shares = [(tables[:, i * half:(i + 1) * half].contiguous(), lens - i * half * 16)
              for i in range(2)]
    assert paged_ops.split_design(D, KV, kp.element_size()) == "cluster"
    before = _split_counts()
    out, passes, ml, parts = _run_split(q, kp, vp, shares, window)
    torch.cuda.synchronize()
    after = _split_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        SHARE_STATS=2, SHARE_VALUES=2, SUM=1, CVT=0)
    assert ml.shape == (B, KV, 2, G, 2) and parts[0].shape == (B, KV, 1, G, D)
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window)
    slack = weight_slack(q, kp, vp, tables, lens, window=window)
    _int8_scores(q, kp, tables, lens, window, ref, slack, qx)
    _hold_q8(out, ref, q, slack, vp, False)
    _hold_q8(out, paged_ops.paged_attention(q, kp, vp, tables, lens, window=window), q,
             slack, vp, False)
    _hold_split_passes(q, kp, vp, shares, window, passes, ml, parts, slack)
    if qx != 1.0:
        return   # the upcast mode truncates nothing: its partials at x1 only
    parts = [paged_ops.paged_attention_partials(q, kp, vp, t, l, window=window, upcast=True)
             for t, l in shares]
    up = paged_ops.paged_merge(torch.cat([a for a, _ in parts], 2),
                               torch.cat([m for _, m in parts], 2), qdt)
    _hold_q8(up, paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window,
                                                 upcast=True), q, slack, vp, True)


# the split at the card's shapes: each table cut into rank shares (its two
# halves, three shares, and the whole table then a share past every row's
# newest token, which holds no key)
SPLIT_FULL = ("llama3.2-3b", "h2o-danube", "llama3-405b", "zamba2", "reasoning-G16",
              "reasoning-G8", "rows-of-one-kv-head", "rows-of-three-kv-heads")
SPLIT_CUTS = ("halves", "thirds", "empty")


def _cut(tables, lens, cut):
    B, n = tables.shape
    if cut == "empty":
        return [(tables, lens), (torch.zeros((B, 16), dtype=tables.dtype,
                                             device=tables.device), lens - n * 16)]
    k = 2 if cut == "halves" else 3
    w = -(-n // k)
    t = torch.nn.functional.pad(tables, (0, k * w - n))
    return [(t[:, i * w:(i + 1) * w].contiguous(), lens - i * w * 16) for i in range(k)]


@pytest.mark.gpu
@pytest.mark.parametrize("cut", SPLIT_CUTS)
@pytest.mark.parametrize("shape", SPLIT_FULL)
@pytest.mark.parametrize("pair", Q8_PAIRS, ids=["/".join(p) for p in Q8_PAIRS])
def test_paged_split_at_the_card_shapes(cuda, pair, shape, cut):
    """The sequence split at the card's shapes, every pair, through the
    cluster passes (``split_design``; 8-bit rows of D 120 under an odd KV
    through the map over token pairs, their instances named " paired"):
    one launch of each pass a share and one sum, no other K2 launch;
    against the one-call kernel and the plain version, each pass against
    its plain version (the scores at their true tokens); a share with no
    key (NEG_INF, 0) and zeros."""
    from repro_torch.kernels.paged_attention.ref import weight_slack
    m = Q8_FULL[shape]
    pages, qdt = (getattr(torch, n) for n in pair)
    q, kp, vp, tables, lens, window = _full_inputs(
        m, pages, qdt, 1200 + SPLIT_FULL.index(shape), cuda, 1.0)
    shares = _cut(tables, lens, cut)
    assert paged_ops.split_design(m["D"], m["KV"], kp.element_size()) == "cluster"
    paired = shape in PAIRED_SHAPES and kp.element_size() == 1
    assert (paged_ops.page_map(m["D"], m["KV"], kp.element_size()) == "paired") == paired
    inst = f"{pair[1]}/{pair[0]} cluster" + (" paired" if paired else "")
    before = _split_counts(), paged_ops.SHARE_STATS.by_instance[inst], \
        paged_ops.SHARE_VALUES.by_instance[inst]
    out, passes, ml, parts = _run_split(q, kp, vp, shares, window)
    torch.cuda.synchronize()
    after = _split_counts()
    R = len(shares)
    assert {k: after[k] - before[0][k] for k in after} == dict(
        SHARE_STATS=R, SHARE_VALUES=R, SUM=1, CVT=0)
    assert (paged_ops.SHARE_STATS.by_instance[inst] - before[1],
            paged_ops.SHARE_VALUES.by_instance[inst] - before[2]) == (R, R)
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window)
    slack = weight_slack(q, kp, vp, tables, lens, window=window)
    _hold_q8(out, ref, q, slack, vp, False, ulp=True)
    _hold_q8(out, paged_ops.paged_attention(q, kp, vp, tables, lens, window=window), q,
             slack, vp, False, ulp=True)
    _hold_split_passes(q, kp, vp, shares, window, passes, ml, parts, slack)
    if cut == "empty":
        from repro_torch.kernels.paged_attention.ref import NEG_INF
        last = passes[-1][0]
        assert bool((last[..., 0] == NEG_INF).all()) and bool((last[..., 1] == 0).all())
        assert bool((parts[-1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["float8_e4m3fn", "int8"])
def test_paged_split_passes_refuse_and_choose(cuda, pages):
    """The split's passes choose their instance by the pool's map and name
    it in ``by_instance``: the per-head map's at llama3-405b's rows, the
    map over token pairs' (" paired") at h2o-danube's one kv head a rank,
    each equal to the one-call kernel within the bound; pass 2 without
    pass 1's scores raises before any launch."""
    from repro_torch.kernels.paged_attention.ref import weight_slack
    pt = getattr(torch, pages)
    for shape, suffix in (("llama3-405b", ""), ("rows-of-one-kv-head", " paired")):
        q, kp, vp, tables, lens, window = _full_inputs(Q8_FULL[shape], pt, torch.bfloat16,
                                                       1300, cuda, 1.0)
        shares = _cut(tables, lens, "halves")
        inst = f"bfloat16/{pages} cluster{suffix}"
        before = paged_ops.SHARE_STATS.by_instance[inst]
        split = _run_split(q, kp, vp, shares, window)[0]
        one = paged_ops.paged_attention(q, kp, vp, tables, lens, window=window)
        torch.cuda.synchronize()
        assert paged_ops.SHARE_STATS.by_instance[inst] == before + 2
        slack = weight_slack(q, kp, vp, tables, lens, window=window)
        _hold_q8(split, one, q, 2 * slack, vp, False)
    ml, _ = paged_ops.paged_attention_stats(q, kp, *shares[0])
    n = paged_ops.SHARE_VALUES.launches
    with pytest.raises(ValueError, match="scores"):
        paged_ops.paged_attention_values(q, kp, vp, *shares[0], ml, None)
    assert paged_ops.SHARE_VALUES.launches == n


@pytest.mark.gpu
def test_paged_other_page_dtype_refusals(cuda):
    """fp32 pages upcast to a bf16 q round the cache down to bf16, as the
    reference's unrolled decode does: the upcast kernel runs them; bf16
    pages under a bf16 q round nothing: no two-pass entry takes them; fp32
    pages under a bf16 q run the fp32 kernel on q in fp32."""
    case = Q8_CASES[-1]
    q, kp, vp, tables, lens, _ = _q8_inputs(case, torch.float32, torch.bfloat16, 1, cuda)
    before = paged_ops.UPCAST.launches
    up = paged_ops.paged_attention(q, kp, vp, tables, lens, upcast=True)
    torch.cuda.synchronize()
    assert paged_ops.UPCAST.launches == before + 1 and up.dtype == torch.bfloat16
    _hold_q8(up, paged_ops.paged_attention_plain(q, kp, vp, tables, lens, upcast=True), q,
             torch.zeros_like(up, dtype=torch.float32), vp, True)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(q, kp, vp, tables, lens)
    assert paged_ops.KERNEL.launches == before + 1 and out.dtype == torch.bfloat16
    _assert_close(out, paged_ops.paged_attention_plain(q, kp, vp, tables, lens), 2e-2, 1e-2)
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    with pytest.raises(ValueError, match="round nothing"):
        paged_ops.paged_attention_stats(q, kb, tables, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("case", Q8_CASES)
def test_paged_fp32_pages_upcast_to_bf16_vs_plain(cuda, case):
    """The upcast mode over fp32 pages under a bf16 q (the reference's
    unrolled decode rounds such a cache to bf16): one launch of the upcast
    kernel, each page rounded to bf16 on load, against the plain version;
    and its partials merged likewise."""
    q, kp, vp, tables, lens, window = _q8_inputs(case, torch.float32, torch.bfloat16,
                                                 800 + Q8_CASES.index(case), cuda)
    assert paged_ops.upcast_design(q.dtype, kp.dtype, q.shape[3], q.shape[1]) == "split"
    inst = "bfloat16/float32 split"
    before = (paged_ops.UPCAST.by_instance[inst], paged_ops.KERNEL.launches)
    out = paged_ops.paged_attention(q, kp, vp, tables, lens, window=window, upcast=True)
    torch.cuda.synchronize()
    assert (paged_ops.UPCAST.by_instance[inst], paged_ops.KERNEL.launches) == \
        (before[0] + 1, before[1])
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window, upcast=True)
    none = torch.zeros_like(ref, dtype=torch.float32)
    _hold_q8(out, ref, q, none, vp, True)
    acc, ml = paged_ops.paged_attention_partials(q, kp, vp, tables, lens, window=window,
                                                 upcast=True)
    _hold_q8(paged_ops.paged_merge(acc, ml, torch.bfloat16), ref, q, none, vp, True)


# ------------------------------------- the one-launch design at the card's shapes
# chip_smoke.Q8_PAGED: llama3.2-3b's decode batch (contexts 128-2048 in
# shuffled pages), h2o-danube's window 4096 at D 120 (contexts 4096-6400),
# llama3-405b's G 16, zamba2's D 80 at G 1; chip_smoke.Q8_MORE: a small
# batch past the cluster's old scores limit (more than 12,288 tokens a
# sequence at G 16, which the two passes ran before), reasoning lengths
# (12,288-33,792 tokens) at G 16 and G 8, sequences past what a block's
# shared memory keeps at any cluster size (their last pages recomputed
# from k), all the cluster; and 8-bit D 120 rows under one kv head
# (h2o-danube at tp 8) and three, which the cluster reads through the map
# over token pairs
Q8_FULL = {
    "llama3.2-3b": dict(B=16, KV=8, G=3, D=128, min_ctx=128, max_ctx=2048),
    "h2o-danube": dict(B=16, KV=8, G=4, D=120, min_ctx=4096, max_ctx=6400, window=4096),
    "llama3-405b": dict(B=16, KV=8, G=16, D=128, min_ctx=128, max_ctx=1280),
    "zamba2": dict(B=16, KV=32, G=1, D=80, min_ctx=128, max_ctx=1280),
    "two-pass": dict(B=2, KV=2, G=16, D=128, min_ctx=12_400, max_ctx=13_000),
    "reasoning-G16": dict(B=16, KV=8, G=16, D=128, min_ctx=12_288, max_ctx=33_792),
    "reasoning-G8": dict(B=16, KV=8, G=8, D=128, min_ctx=12_288, max_ctx=33_792),
    "overflow": dict(B=2, KV=8, G=16, D=128, min_ctx=60_000, max_ctx=65_536),
    "rows-of-one-kv-head": dict(B=16, KV=1, G=4, D=120, min_ctx=4096, max_ctx=6400,
                                window=4096),
    "rows-of-three-kv-heads": dict(B=16, KV=3, G=4, D=120, min_ctx=4096, max_ctx=6400,
                                   window=4096),
}
PAIRED_SHAPES = ("rows-of-one-kv-head", "rows-of-three-kv-heads")


def _full_inputs(m, pages, qdt, seed, cuda, qx):
    """B sequences of min_ctx..max_ctx tokens (the first max_ctx) in
    shuffled pages of one pool, as chip_smoke.paged_main_inputs; int8's
    values times 3."""
    from repro_torch.models.cache_dtype import to_cache_dtype
    rng = np.random.default_rng(seed)
    ctx = rng.integers(m["min_ctx"], m["max_ctx"] + 1, size=m["B"])
    ctx[0] = m["max_ctx"]
    n_blocks = -(-ctx // 16)
    P = int(n_blocks.sum()) + 64
    perm = rng.permutation(P).astype(np.int32)
    tables = np.zeros((m["B"], int(n_blocks.max())), np.int32)
    used = 0
    for b, n in enumerate(n_blocks):
        tables[b, :n] = perm[used:used + n]
        used += n
    scale = 3.0 if pages == torch.int8 else 1.0
    q = torch.from_numpy(rng.standard_normal((m["B"], m["KV"], m["G"], m["D"])).astype(
        np.float32) * qx).to(cuda, qdt)
    kp, vp = (to_cache_dtype(torch.from_numpy(rng.standard_normal(
        (P, 16, m["KV"], m["D"])).astype(np.float32)).to(cuda) * scale, pages)
        for _ in range(2))
    return (q, kp, vp, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(ctx - 1).to(cuda, torch.int32), m.get("window", 0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(Q8_FULL))
@pytest.mark.parametrize("pair,qx", Q8_RUNS, ids=Q8_IDS)
def test_paged_cvt_design_at_the_card_shapes(cuda, pair, qx, shape):
    """K2's default mode at the card's shapes, every pair, int8 also under
    q x12 and x40: one launch of the cluster (``cvt_design``) at every
    length, 8-bit rows of D 120 under an odd KV through the map over token
    pairs (its " paired" instance), against the plain version under
    chip_smoke.hold_q8's bounds; int8 rows without slack exactly."""
    from repro_torch.kernels.paged_attention.ref import weight_slack
    m = Q8_FULL[shape]
    pages, qdt = (getattr(torch, n) for n in pair)
    q, kp, vp, tables, lens, window = _full_inputs(m, pages, qdt,
                                                   1000 + list(Q8_FULL).index(shape), cuda, qx)
    design = paged_ops.cvt_design(tables.shape[1], m["G"], window, m["D"], m["KV"],
                                  kp.element_size())
    # 8-bit rows of D 120 under an odd KV; bf16 pages' rows are 240 bytes
    paired = shape in PAIRED_SHAPES and kp.element_size() == 1
    assert design == "cluster"
    inst = f"{pair[1]}/{pair[0]} {design}" + (" paired" if paired else "")
    before = (paged_ops.CVT.by_instance[inst], paged_ops.CVT.launches)
    out = paged_ops.paged_attention(q, kp, vp, tables, lens, window=window)
    torch.cuda.synchronize()
    assert (paged_ops.CVT.by_instance[inst], paged_ops.CVT.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window)
    slack = weight_slack(q, kp, vp, tables, lens, window=window)
    _int8_scores(q, kp, tables, lens, window, ref, slack, qx)
    _hold_q8(out, ref, q, slack, vp, False)
    if pages == torch.int8:   # integer products, weights 0 or 1
        exact = slack.amax(dim=-1) == 0
        assert float((out.float() - ref.float()).abs()[exact].max()) == 0.0


# ------------------------------------- the upcast mode's cluster design
# The upcast mode (``decode_unroll``) over fp8 e4m3 and int8 pages under a
# bf16 q runs one launch of a thread block cluster per (batch row, kv head)
# (``csrc/paged_cluster_upcast.cuh``): at the card's four main shapes and at
# reasoning lengths and h2o-danube's rows under one and three kv heads (the
# map over token pairs) (Q8_FULL), and at the edges of its split into
# blocks: single-page rows, rows shorter than a cluster's blocks beside one
# long row (its span sets C), a window with rows shorter than it, all in
# shuffled pages
UPCAST_FULL = {
    **{k: Q8_FULL[k] for k in ("llama3.2-3b", "h2o-danube", "llama3-405b", "zamba2",
                               "reasoning-G16", "reasoning-G8", *PAIRED_SHAPES)},
    "single-page rows": dict(B=16, KV=8, G=16, D=128, min_ctx=1, max_ctx=16),
    "rows shorter than C pages": dict(B=16, KV=8, G=3, D=128, min_ctx=1, max_ctx=4096),
    "window, rows shorter than it": dict(B=8, KV=8, G=4, D=120, min_ctx=16, max_ctx=5000,
                                         window=4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(UPCAST_FULL))
@pytest.mark.parametrize("pages", ["float8_e4m3fn", "int8"])
def test_paged_upcast_cluster_vs_plain(cuda, pages, shape):
    """One launch of the upcast mode's cluster instance (``upcast_design``),
    against the plain version under the upcast tolerance; none of the
    same-dtype kernel's or the default mode's."""
    m = UPCAST_FULL[shape]
    pt = getattr(torch, pages)
    q, kp, vp, tables, lens, window = _full_inputs(m, pt, torch.bfloat16,
                                                   1100 + list(UPCAST_FULL).index(shape), cuda,
                                                   1.0)
    assert paged_ops.upcast_design(q.dtype, pt, m["D"], m["KV"]) == "cluster"
    inst = f"bfloat16/{pages} cluster" + (" paired" if shape in PAIRED_SHAPES else "")
    before = (paged_ops.UPCAST.by_instance[inst], paged_ops.UPCAST.launches,
              paged_ops.CVT.launches, paged_ops.KERNEL.launches)
    out = paged_ops.paged_attention(q, kp, vp, tables, lens, window=window, upcast=True)
    torch.cuda.synchronize()
    assert (paged_ops.UPCAST.by_instance[inst], paged_ops.UPCAST.launches,
            paged_ops.CVT.launches, paged_ops.KERNEL.launches) == \
        (before[0] + 1, before[1] + 1, before[2], before[3])
    assert out.dtype == torch.bfloat16
    ref = paged_ops.paged_attention_plain(q, kp, vp, tables, lens, window=window, upcast=True)
    _hold_q8(out, ref, q, torch.zeros_like(ref, dtype=torch.float32), vp, True)
