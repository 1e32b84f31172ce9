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
def test_flash_bf16_misaligned_raises(cuda):
    """The bf16 instance reads through TMA, which needs 16-byte aligned
    bases: the wrapper refuses a q that starts 2 bytes into its storage."""
    shape = (1, 64, 2, 64)
    n = int(np.prod(shape))
    q = torch.zeros(n + 1, dtype=torch.bfloat16, device=cuda)[1:].view(shape)
    k = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    before = flash_ops.KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops.flash_attention(q, k, k)
    assert flash_ops.KERNEL.launches == before
