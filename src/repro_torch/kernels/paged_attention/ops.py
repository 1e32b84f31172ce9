"""Wrapper of the CUDA paged-attention decode kernel
(``csrc/paged_attention.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. One call runs two kernels on the caller's stream: a split over the
sequence that writes each 16-page partition's fp32 partial into scratch
this wrapper allocates, and a merge into the output. bf16 runs the
tensor-core split kernel, fp32 the SIMT one; the dtype alone chooses.
Head dims 80, 112 and 120 run on the 128 instance's geometry with the
pad zeroed; a group of 9 to 16 q heads takes a second tile of queries.
``KERNEL.launches`` counts the calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import DTYPE_CODES, CudaKernel
from repro_torch.kernels.paged_attention.ref import paged_attention_plain

__all__ = ["KERNEL", "paged_attention", "paged_attention_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_attention", "paged_attention_fwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
HEAD_DIMS = (32, 64, 80, 112, 120, 128)
PAGE = 16       # tokens per page, fixed in the kernel
MAX_GROUP = 16  # most q heads per kv head the kernel takes
PART = 16       # pages per partition of the split kernel, fixed in the kernel


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lens: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """One-token decode attention. q (B,KV,G,D) kv-major; k/v_pages
    (P,16,KV,D); block_tables (B,max_blocks) int32 page ids, every entry a
    valid page; lens (B,) int32 inclusive index of the newest token; a
    window > 0 keeps the keys at ``lens - window < pos <= lens``. Scores
    are scaled by D ** -0.5. Returns (B,KV,G,D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables, lens,
                                     window=window)
    _check(q, k_pages, v_pages, block_tables, lens)
    B, KV, G, D = q.shape
    max_blocks = block_tables.shape[1]
    out = torch.empty_like(q)
    # each partition's fp32 acc (G, D) and (m, l) per query row
    n_part = -(-max_blocks // PART)
    scratch = torch.empty(B * KV * n_part * G * (D + 2), dtype=torch.float32,
                          device=q.device)
    KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), B, KV, G, D, max_blocks, int(window),
                  D ** -0.5,
                  DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _check(q, k_pages, v_pages, block_tables, lens):
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: tensors on {q.device}, not cuda")
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, KV, G, D = q.shape
    if tuple(k_pages.shape[1:]) != (PAGE, KV, D):
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} must "
                         f"be (P, {PAGE}, {KV}, {D})")
    if D not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"paged_attention: head dim {D} (need one of "
                         f"{HEAD_DIMS}) or group {G} (need 1..{MAX_GROUP})")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}; need one of "
                         f"{list(DTYPE_CODES)}")
    if block_tables.dtype != torch.int32 or block_tables.ndim != 2 \
            or block_tables.shape[0] != B or block_tables.shape[1] < 1:
        raise ValueError("paged_attention: block_tables must be int32 "
                         f"(B={B}, max_blocks>=1)")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise ValueError(f"paged_attention: lens must be int32 of shape ({B},)")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte aligned")
