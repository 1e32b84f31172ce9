"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip on a machine without a CUDA card, where a kernel
cannot run. This file imports no JAX, so it runs on a card machine without
it (see README.md). Tolerances: 2e-3 in fp32, 2e-2 in bf16.
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
]
PAGED_CASES = [
    # B, KV, G, D, page, P, nblk
    (2, 2, 4, 64, 16, 16, 4),
    (3, 4, 1, 64, 16, 32, 6),       # MHA-style
    (1, 1, 8, 128, 16, 8, 8),       # MQA, deep table
    (4, 2, 2, 32, 16, 64, 3),
    (16, 8, 3, 128, 16, 1024, 64),  # llama3.2-3b decode batch
]
DTYPES = {"float32": (torch.float32, 2e-3), "bfloat16": (torch.bfloat16, 2e-2)}


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
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_kernel_vs_plain(cuda, case, dtype):
    q, kp, vp, tables, lens = _paged_inputs(case, 400 + PAGED_CASES.index(case))
    tdt, tol = DTYPES[dtype]
    qt, kt, vt = (torch.from_numpy(a).to(cuda, tdt) for a in (q, kp, vp))
    tt, lt = torch.from_numpy(tables).to(cuda), torch.from_numpy(lens).to(cuda)
    before = paged_ops.KERNEL.launches
    out = paged_ops.paged_attention(qt, kt, vt, tt, lt)
    torch.cuda.synchronize()
    assert paged_ops.KERNEL.launches == before + 1
    ref = paged_ops.paged_attention_plain(qt, kt, vt, tt, lt)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)
