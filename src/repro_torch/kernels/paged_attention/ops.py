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

Two more entries expose the halves, for a decode whose cache sequence is
cut over ranks: ``paged_attention_partials`` runs the split kernel alone
over a rank's share of the table and returns its partitions' fp32
partials, and ``paged_merge`` merges any number of partitions, those the
ranks gathered. ``PARTIALS.launches`` and ``MERGE.launches`` count them.

On a meta tensor (``repro_torch.analysis``'s dry-run) each wrapper books
its kernel's operations and device-memory bytes with the active op counter
and returns an empty meta result; it runs neither the kernel nor its plain
version. Without values it books every sequence's table full, within the
window: the count of the rank that holds the newest token.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis import scopes
from repro_torch.kernels.build import DTYPE_CODES, CudaKernel
from repro_torch.kernels.paged_attention.ref import (
    NEG_INF, paged_attention_partials_plain, paged_attention_plain,
    paged_merge_plain)

__all__ = ["KERNEL", "MERGE", "PARTIALS", "paged_attention",
           "paged_attention_partials", "paged_attention_plain",
           "paged_attention_partials_plain", "paged_merge",
           "paged_merge_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_attention", "paged_attention_fwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
PARTIALS = CudaKernel("paged_attention", "paged_attention_partials",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P])
MERGE = CudaKernel("paged_attention", "paged_merge_fwd",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
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
    if q.device.type == "meta":
        out = torch.empty_like(q)
        _book_split("paged_attention", q, block_tables, lens, window, (out,))
        return out
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


def paged_attention_partials(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_tables: torch.Tensor,
                             lens: torch.Tensor, *, window: int = 0):
    """The split half of ``paged_attention`` over a share of each
    sequence's positions that ``block_tables`` holds: lens (B,) int32 is the
    newest token's index counted from the table's first position, and may
    lie past the table's end (every token of the share counts) or before
    its start (none does); the window is applied to the same positions.
    Returns fp32 (acc (B,KV,P,G,D), ml (B,KV,P,G,2)), P = ceil(max_blocks /
    16): each partition's sum of exp(score - m) * v and its (m, l); a
    partition with no key that counts holds (0, (NEG_INF, 0))."""
    if q.device.type == "cpu":
        return paged_attention_partials_plain(q, k_pages, v_pages, block_tables,
                                              lens, window=window, part=PART)
    B, KV, G, D = q.shape
    n_part = -(-block_tables.shape[1] // PART)
    acc = torch.zeros((B, KV, n_part, G, D), dtype=torch.float32, device=q.device)
    ml = torch.zeros((B, KV, n_part, G, 2), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _book_split("paged_attention_partials", q, block_tables, lens, window,
                    (acc, ml))
        return acc, ml
    _check(q, k_pages, v_pages, block_tables, lens)
    ml[..., 0] = NEG_INF        # the partitions that no block writes
    PARTIALS.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lens.data_ptr(), acc.data_ptr(),
                    ml.data_ptr(), B, KV, G, D, block_tables.shape[1],
                    int(window), D ** -0.5, DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    return acc, ml


def paged_merge(acc: torch.Tensor, ml: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Merge every partition of ``paged_attention_partials``' results (of
    one rank, or several gathered along dim 2): acc (B,KV,P,G,D), ml
    (B,KV,P,G,2) fp32 -> (B,KV,G,D) in ``dtype``."""
    if acc.device.type == "cpu":
        return paged_merge_plain(acc, ml, dtype)
    B, KV, P, G, D = acc.shape
    out = torch.empty((B, KV, G, D), dtype=dtype, device=acc.device)
    if acc.device.type == "meta":
        scopes.book(hbm=sum(scopes.strict_bytes(t) for t in (acc, ml, out)),
                    eager=sum(t.numel() * t.element_size() for t in (acc, ml, out)))
        return out
    if acc.dtype != torch.float32 or ml.dtype != torch.float32 \
            or tuple(ml.shape) != (B, KV, P, G, 2) or not acc.is_cuda \
            or ml.device != acc.device or not (acc.is_contiguous() and ml.is_contiguous()):
        raise ValueError(f"paged_merge: acc {tuple(acc.shape)} {acc.dtype} and ml "
                         f"{tuple(ml.shape)} {ml.dtype} must be contiguous fp32 "
                         "(B,KV,P,G,D) and (B,KV,P,G,2) on one CUDA device")
    if D not in HEAD_DIMS or dtype not in DTYPE_CODES:
        raise ValueError(f"paged_merge: head dim {D} or dtype {dtype}")
    MERGE.launch(acc.data_ptr(), ml.data_ptr(), out.data_ptr(), B, KV, G, D, P,
                 DTYPE_CODES[dtype], torch.cuda.current_stream(acc.device).cuda_stream)
    return out


def counted_tokens(block_tables: torch.Tensor, window: int) -> int:
    """The keys a sequence reads on meta: its whole table, within the
    window."""
    n = block_tables.shape[1] * PAGE
    return min(n, window) if window > 0 else n


def _book_split(name, q, block_tables, lens, window, outs):
    """On meta: the split kernel's products (q.k and p.v over the counted
    keys) and bytes (those keys' k and v rows, q, the table and lens read
    once, ``outs`` written once)."""
    B, KV, G, D = q.shape
    keys = B * KV * counted_tokens(block_tables, window)
    kv_elem = 2 * keys * D
    ts = (q, block_tables, lens, *outs)
    scopes.book(flops=4.0 * keys * G * D, name=name,
                hbm=kv_elem * scopes.FLOAT_BYTES + sum(scopes.strict_bytes(t) for t in ts),
                eager=kv_elem * q.element_size() + sum(t.numel() * t.element_size()
                                                       for t in ts))


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
