"""Wrapper of the CUDA paged-attention decode kernel
(``csrc/paged_attention.cu``) and of its instances for pages of another
dtype than q (``csrc/paged_attention_cvt.cu``, ``paged_attention_upcast.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. One call runs two kernels on the caller's stream: a split over the
sequence that writes each 16-page partition's fp32 partial into scratch
this wrapper allocates, and a merge into the output. bf16 runs the
tensor-core split kernel, fp32 the SIMT one; the dtype alone chooses.
Head dims 80, 112 and 120 run on the 128 instance's geometry with the
pad zeroed; a group of 9 to 16 q heads takes a second tile of queries.
``KERNEL.launches`` counts the calls.

Pages of another dtype than q (a cache of the reference's
``kv_cache_dtype``: fp8 e4m3 or int8 under a bf16 or fp32 q, bf16 under an
fp32 q) take ``decode_attention``'s function, which rounds q*scale and the
normalised weights to the pages' dtype: ``CVT``, one launch of a thread
block cluster per (batch row, kv head) that reads v once and k once where
the scores fit a block's shared memory (k again for the overflow past it)
at every length (``csrc/paged_cluster.cuh``). Under ``upcast=True`` (the
reference's ``decode_unroll``, which upcasts the cache to q's dtype) they
take ``UPCAST`` in one of two designs that ``upcast_design`` chooses: one
launch of a thread block cluster per (batch row, kv head), an online
softmax a block over pages read once by TMA, for 8-bit pages under a bf16
q (``csrc/paged_cluster_upcast.cuh``), or the one-pass split kernel with
the pages converted on load and its merge (two launches, one count) for an
fp32 q and for fp32 pages under a bf16 q, rounded to bf16 on load as the
reference's upcast rounds them. Without it fp32 pages under a bf16 q round
nothing, so the fp32 kernel runs them on q in fp32. The cluster designs
read a kv head's rows through one of three tensor maps (``page_map``): per
head, over all heads (8-bit rows of D 120 under an even KV) or over token
pairs (under an odd KV: h2o-danube's one kv head a rank at tp 8). Each
counter's ``by_instance`` names q's and the pages' dtype, and ``CVT``'s
and ``UPCAST``'s the design, with " paired" after a cluster that took the
map over token pairs.

Two more entries expose the halves, for a decode whose cache sequence is
cut over ranks: ``paged_attention_partials`` runs the split kernel alone
over a rank's share of the table and returns its partitions' fp32
partials, and ``paged_merge`` merges any number of partitions, those the
ranks gathered. ``PARTIALS.launches`` and ``MERGE.launches`` count them
(``UPCAST_PARTIALS`` the upcast pages'); the same-dtype counters'
``by_instance`` name q's dtype (the output's for ``MERGE``), which picks the
bf16 tensor-core or the fp32 SIMT instance. ``decode_attention``'s function
splits in two passes and a sum, each pass one thread block cluster launch
(``csrc/paged_attention_split.cu``; ``SHARE_STATS``, ``SHARE_VALUES``):
``paged_attention_stats`` (pass 1: the share's (m, l) and its scores),
``paged_attention_values`` (pass 2: the ranks' gathered (m, l) merged into
the sequence's (M, L), then the share's sum of the rounded weights times v
from the stored scores and v, never k) and ``paged_sum`` (the gathered
sums added; ``SUM``).

On a meta tensor (``repro_torch.analysis``'s dry-run) each wrapper books
its kernel's operations and device-memory bytes with the active op counter
and returns an empty meta result; it runs neither the kernel nor its plain
version. Without values it books every sequence's table full, within the
window: the count of the rank that holds the newest token.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.analysis import scopes
from repro_torch.kernels.build import DTYPE_CODES, PAGE_CODES, CudaKernel
from repro_torch.kernels.paged_attention.ref import (
    NEG_INF, paged_attention_partials_plain, paged_attention_plain,
    paged_attention_stats_plain, paged_attention_values_plain,
    paged_merge_plain, paged_sum_plain, rounds_weights)

__all__ = ["CVT", "KERNEL", "MERGE", "PARTIALS", "SHARE_STATS", "SHARE_VALUES", "SUM",
           "UPCAST", "UPCAST_PARTIALS", "cvt_design", "page_map", "paged_attention",
           "paged_attention_partials", "paged_attention_plain",
           "paged_attention_partials_plain", "paged_attention_stats",
           "paged_attention_values", "paged_merge", "paged_merge_plain", "paged_sum",
           "split_design", "upcast_design"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("paged_attention", "paged_attention_fwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
PARTIALS = CudaKernel("paged_attention", "paged_attention_partials",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P])
MERGE = CudaKernel("paged_attention", "paged_merge_fwd",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
_SPLIT_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
               _I, _I, _P]
CVT = CudaKernel("paged_attention_cvt", "paged_cvt_fwd",
                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                  _I, _I, _I, _P])
UPCAST = CudaKernel("paged_attention_upcast", "paged_upcast_fwd",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                     _I, _I, _I, _I, _P])
UPCAST_PARTIALS = CudaKernel("paged_attention_upcast", "paged_upcast_partials",
                             _SPLIT_ARGS)
SUM = CudaKernel("paged_attention_cvt", "paged_cvt_sum",
                 [_P, _P, _I, _I, _I, _I, _I, _I, _P])
SHARE_STATS = CudaKernel("paged_attention_split", "paged_cvt_share_stats",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                          _I, _I, _I, _P])
SHARE_VALUES = CudaKernel("paged_attention_split", "paged_cvt_share_values",
                          [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])
# every counter of the module, for a caller that sets them to 0
COUNTERS = (KERNEL, PARTIALS, MERGE, CVT, UPCAST, UPCAST_PARTIALS, SUM, SHARE_STATS,
            SHARE_VALUES)
HEAD_DIMS = (32, 64, 80, 112, 120, 128)
PAGE = 16       # tokens per page, fixed in the kernel
MAX_GROUP = 16  # most q heads per kv head the kernel takes
PART = 16       # pages per partition of the split kernel, fixed in the kernel
UPCAST_DESIGNS = {"split": 0, "cluster": 1}   # the ``design`` argument of ``paged_upcast_fwd``
ROW = 128       # bytes of a token row in a cluster's TMA box (``csrc/paged_cluster.cuh``)


def page_map(D: int, KV: int, page_bytes: int) -> str:
    """The tensor map through which the cluster designs read a kv head's
    rows, as ``csrc/paged_cluster.cuh``'s ``make_page_maps`` picks it:
    "per_head" where a row of D elements is a 16-byte stride, else "flat"
    (one box over all heads' rows of a token) where a token's KV rows are,
    else "paired" (8-bit rows of D 120 under an odd KV: boxes over token
    pairs, whose 2 x KV x D bytes always are)."""
    row = D * page_bytes
    return "per_head" if row % 16 == 0 else "flat" if (KV * row) % 16 == 0 else "paired"


def _row_bytes(D: int, page_bytes: int) -> int:
    """The bytes a cluster's TMA box reads of one kv head's token row: the
    row's own under the per-head map, else the box's ``ROW`` (the 16-byte
    boundary at or before the row to 128 bytes on: 128 of D 120's)."""
    return D * page_bytes if (D * page_bytes) % 16 == 0 else ROW


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address, or a null pointer for none."""
    return None if t is None else t.data_ptr()


def upcast_design(q_dtype: torch.dtype, page_dtype: torch.dtype, D: int, KV: int) -> str:
    """The design that runs ``paged_attention(upcast=True)`` over pages of
    ``page_dtype``, another dtype than q's ``q_dtype`` (pages of q's dtype
    take the same-dtype kernel, with nothing to upcast): "cluster" for fp8
    e4m3 or int8 pages under a bf16 q (one launch,
    ``csrc/paged_cluster_upcast.cuh``, through the map ``page_map(D, KV,
    1)`` names: every head dim and kv head count of the configs); else
    "split" (an fp32 q, fp32 pages under a bf16 q). The split half under
    ``seq_shard_decode`` (``paged_attention_partials``) runs the split
    kernel whatever this says."""
    if q_dtype == torch.bfloat16 and page_dtype in (torch.float8_e4m3fn, torch.int8):
        return "cluster"
    return "split"


def cvt_design(max_blocks: int, G: int, window: int, D: int, KV: int,
               page_bytes: int) -> str:
    """The design that runs ``decode_attention``'s function over pages of
    ``page_bytes`` an element: the one-launch "cluster"
    (``csrc/paged_cluster.cuh``) at every table width, group, window, head
    dim and kv head count (a block's scores past its shared memory are
    recomputed from k in the same launch; the rows come through
    ``page_map``'s map), so the row's arguments never change it."""
    return "cluster"


def split_design(D: int, KV: int, page_bytes: int) -> str:
    """The design that runs ``decode_attention``'s function split over the
    sequence (``paged_attention_stats`` ... ``paged_sum``) over pages of
    ``page_bytes`` an element: "cluster", two cluster launches
    (``csrc/paged_split_cluster.cuh``) through ``page_map``'s map at every
    head dim and kv head count."""
    return "cluster"


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lens: torch.Tensor, *, window: int = 0,
                    upcast: bool = False) -> torch.Tensor:
    """One-token decode attention. q (B,KV,G,D) kv-major; k/v_pages
    (P,16,KV,D); block_tables (B,max_blocks) int32 page ids, every entry a
    valid page; lens (B,) int32 inclusive index of the newest token; a
    window > 0 keeps the keys at ``lens - window < pos <= lens``. Scores
    are scaled by D ** -0.5. Pages of another dtype than q take
    ``decode_attention``'s rounding, or with ``upcast`` are read as q's
    dtype (the module docstring). Returns (B,KV,G,D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables, lens,
                                     window=window, upcast=upcast)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        boxes = rounds_weights(q, k_pages, upcast) or (
            upcast and upcast_design(q.dtype, k_pages.dtype, q.shape[3], q.shape[1])
            == "cluster")
        _book_split("paged_attention", q, k_pages, block_tables, lens, window, (out,),
                    boxes=boxes)
        return out
    _check(q, k_pages, v_pages, block_tables, lens)
    if k_pages.dtype == torch.float32 and q.dtype != torch.float32 and not upcast:
        return paged_attention(q.float(), k_pages, v_pages, block_tables, lens,
                               window=window).to(q.dtype)
    B, KV, G, D = q.shape
    max_blocks = block_tables.shape[1]
    out = torch.empty_like(q)
    n_part = -(-max_blocks // PART)
    if k_pages.dtype == q.dtype:
        # each partition's fp32 acc (G, D) and (m, l) per query row
        scratch = torch.empty(B * KV * n_part * G * (D + 2), dtype=torch.float32,
                              device=q.device)
        KERNEL.launch(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                      scratch.data_ptr(), B, KV, G, D, max_blocks, int(window),
                      D ** -0.5, DTYPE_CODES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream,
                      instance=str(q.dtype)[6:])
        return out
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), out.data_ptr())
    codes = (B, KV, G, D, max_blocks, int(window), D ** -0.5, DTYPE_CODES[q.dtype],
             PAGE_CODES[k_pages.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if upcast:
        design = upcast_design(q.dtype, k_pages.dtype, D, KV)
        # the split's partitions; the cluster merges in shared memory
        scratch = torch.empty(B * KV * n_part * G * (D + 2), dtype=torch.float32,
                              device=q.device) if design == "split" else None
        UPCAST.launch(*args, _ptr(scratch), *codes, UPCAST_DESIGNS[design],
                      k_pages.shape[0], stream,
                      instance=_instance(q, k_pages, design))
        return out
    CVT.launch(*args, *codes, k_pages.shape[0], stream,
               instance=_instance(q, k_pages, "cluster"))
    return out


def paged_attention_partials(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, block_tables: torch.Tensor,
                             lens: torch.Tensor, *, window: int = 0,
                             upcast: bool = False):
    """The split half of ``paged_attention`` over a share of each
    sequence's positions that ``block_tables`` holds: lens (B,) int32 is the
    newest token's index counted from the table's first position, and may
    lie past the table's end (every token of the share counts) or before
    its start (none does); the window is applied to the same positions.
    Returns fp32 (acc (B,KV,P,G,D), ml (B,KV,P,G,2)), P = ceil(max_blocks /
    16): each partition's sum of exp(score - m) * v and its (m, l); a
    partition with no key that counts holds (0, (NEG_INF, 0)). Pages that
    ``decode_attention`` would round to (another dtype than q's, not fp32)
    need ``upcast``; without it their split is ``paged_attention_stats``
    and ``paged_attention_values``."""
    if rounds_weights(q, k_pages, upcast) and q.device.type != "meta":
        raise ValueError(f"paged_attention_partials: {k_pages.dtype} pages under a "
                         f"{q.dtype} q round the normalised weights, which one pass "
                         "cannot: split with paged_attention_stats and "
                         "paged_attention_values, or pass upcast=True")
    if q.device.type == "cpu":
        if upcast:
            k_pages, v_pages = k_pages.to(q.dtype), v_pages.to(q.dtype)
        return paged_attention_partials_plain(q, k_pages, v_pages, block_tables,
                                              lens, window=window, part=PART)
    B, KV, G, D = q.shape
    n_part = -(-block_tables.shape[1] // PART)
    acc = torch.zeros((B, KV, n_part, G, D), dtype=torch.float32, device=q.device)
    ml = torch.zeros((B, KV, n_part, G, 2), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _book_split("paged_attention_partials", q, k_pages, block_tables, lens,
                    window, (acc, ml))
        return acc, ml
    _check(q, k_pages, v_pages, block_tables, lens)
    if k_pages.dtype == torch.float32 and q.dtype != torch.float32 and not upcast:
        q = q.float()
    ml[..., 0] = NEG_INF        # the partitions that no block writes
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), acc.data_ptr(),
            ml.data_ptr(), B, KV, G, D, block_tables.shape[1],
            int(window), D ** -0.5, DTYPE_CODES[q.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if k_pages.dtype == q.dtype:
        PARTIALS.launch(*args, stream, instance=str(q.dtype)[6:])
    else:
        UPCAST_PARTIALS.launch(*args, PAGE_CODES[k_pages.dtype], stream,
                               instance=_instance(q, k_pages))
    return acc, ml


def paged_attention_stats(q: torch.Tensor, k_pages: torch.Tensor,
                          block_tables: torch.Tensor, lens: torch.Tensor, *,
                          window: int = 0):
    """Pass 1 of ``decode_attention``'s function over a share of each
    sequence (``lens`` as ``paged_attention_partials``'): (ml, scores)
    fp32, ml (B,KV,1,G,2) the share's (m, l) of the scores of q*scale
    rounded to the pages' dtype, (NEG_INF, 0) where no key counts, and
    scores (B,KV,max_blocks,G,16) each page's scores where the share's keys
    lie in the window (pass 2 reads those alone). Gather ml over the ranks
    along dim 2 for ``paged_attention_values``."""
    if q.device.type == "cpu":
        return paged_attention_stats_plain(q, k_pages, block_tables, lens, window=window)
    B, KV, G, D = q.shape
    max_blocks = block_tables.shape[1]
    ml = torch.empty((B, KV, 1, G, 2), dtype=torch.float32, device=q.device)
    scores = torch.empty((B, KV, max_blocks, G, PAGE), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _book_split("paged_attention_stats", q, k_pages, block_tables, lens, window,
                    (ml,), rows=1, scores=True, boxes=True)
        return ml, scores
    _check(q, k_pages, k_pages, block_tables, lens)
    _check_rounding(q, k_pages)
    SHARE_STATS.launch(q.data_ptr(), k_pages.data_ptr(), block_tables.data_ptr(),
                       lens.data_ptr(), scores.data_ptr(), ml.data_ptr(), B, KV, G, D,
                       max_blocks, int(window), D ** -0.5, DTYPE_CODES[q.dtype],
                       PAGE_CODES[k_pages.dtype], k_pages.shape[0],
                       torch.cuda.current_stream(q.device).cuda_stream,
                       instance=_instance(q, k_pages, "cluster"))
    return ml, scores


def paged_attention_values(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lens: torch.Tensor, ml: torch.Tensor,
                           scores: Optional[torch.Tensor], *,
                           window: int = 0) -> torch.Tensor:
    """Pass 2 over the same share as ``paged_attention_stats``: ``ml`` its
    (m, l) gathered over the ranks along dim 2 (B,KV,R,G,2), merged here
    into the sequence's (M, L); ``scores`` its scores. Returns the fp32
    sum (B,KV,1,G,D) of the weights exp(s - M) / L rounded to the pages'
    dtype times v (from the scores and v; k is not read); zeros where no
    key counts. Gather it over the ranks along dim 2 for ``paged_sum``."""
    if q.device.type == "cpu":
        return paged_attention_values_plain(q, k_pages, v_pages, block_tables, lens, ml,
                                            scores, window=window)
    B, KV, G, D = q.shape
    max_blocks = block_tables.shape[1]
    acc = torch.empty((B, KV, 1, G, D), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _book_split("paged_attention_values", q, k_pages, block_tables, lens, window,
                    (ml, acc), rows=1, scores=True, boxes=True)
        return acc
    _check(q, k_pages, v_pages, block_tables, lens)
    _check_rounding(q, k_pages)
    _check_f32("paged_attention_values", ml)
    if ml.ndim != 5 or tuple(ml.shape[:2]) != (B, KV) or tuple(ml.shape[3:]) != (G, 2):
        raise ValueError(f"paged_attention_values: ml {tuple(ml.shape)}, need "
                         f"(B={B}, KV={KV}, R, G={G}, 2)")
    if scores is None or tuple(scores.shape) != (B, KV, max_blocks, G, PAGE):
        raise ValueError(f"paged_attention_values: scores "
                         f"{None if scores is None else tuple(scores.shape)}, need "
                         f"{(B, KV, max_blocks, G, PAGE)} from paged_attention_stats")
    _check_f32("paged_attention_values", scores)
    SHARE_VALUES.launch(v_pages.data_ptr(), scores.data_ptr(), ml.data_ptr(), ml.shape[2],
                        block_tables.data_ptr(), lens.data_ptr(), acc.data_ptr(), B, KV, G, D,
                        max_blocks, int(window), PAGE_CODES[v_pages.dtype], v_pages.shape[0],
                        torch.cuda.current_stream(q.device).cuda_stream,
                        instance=_instance(q, v_pages, "cluster"))
    return acc


def paged_sum(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pass 2's sums (B,KV,R,G,D) fp32 (one rank's, or the R ranks'
    gathered along dim 2) added up -> (B,KV,G,D) in ``dtype``."""
    if acc.device.type == "cpu":
        return paged_sum_plain(acc, dtype)
    B, KV, P, G, D = acc.shape
    out = torch.empty((B, KV, G, D), dtype=dtype, device=acc.device)
    if acc.device.type == "meta":
        scopes.book(hbm=sum(scopes.strict_bytes(t) for t in (acc, out)),
                    eager=sum(t.numel() * t.element_size() for t in (acc, out)))
        return out
    _check_f32("paged_sum", acc)
    if dtype not in DTYPE_CODES:
        raise ValueError(f"paged_sum: dtype {dtype}")
    SUM.launch(acc.data_ptr(), out.data_ptr(), B, KV, G, D, P, DTYPE_CODES[dtype],
               torch.cuda.current_stream(acc.device).cuda_stream)
    return out


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
                 DTYPE_CODES[dtype], torch.cuda.current_stream(acc.device).cuda_stream,
                 instance=str(dtype)[6:])
    return out


def counted_tokens(block_tables: torch.Tensor, window: int) -> int:
    """The keys a sequence reads on meta: its whole table, within the
    window."""
    n = block_tables.shape[1] * PAGE
    return min(n, window) if window > 0 else n


def _book_split(name, q, k_pages, block_tables, lens, window, outs, rows=2,
                scores=False, boxes=False):
    """On meta: the kernel's products (q.k and p.v over the counted keys)
    and bytes (those keys' k and v rows in the pages' dtype, an int8
    pool's at one byte, q, the table and lens read once, ``outs`` written
    once); with ``rows`` 1 one product and one of k or v (a pass of
    ``decode_attention``'s split), and with ``scores`` each counted key's
    fp32 score a query row, written by pass 1 and read by pass 2 (strict:
    at ``FLOAT_BYTES``, as every float). With ``boxes`` (a cluster design)
    the eager bytes count each row as its TMA box reads it
    (``_row_bytes``: 128 of an 8-bit row of D 120)."""
    B, KV, G, D = q.shape
    keys = B * KV * counted_tokens(block_tables, window)
    kv_elem = rows * keys * D
    ts = (q, block_tables, lens, *outs)
    n_scores = keys * G if scores else 0
    page_bytes = scopes.FLOAT_BYTES if k_pages.is_floating_point() else \
        k_pages.element_size()
    row = _row_bytes(D, k_pages.element_size()) if boxes else D * k_pages.element_size()
    scopes.book(flops=2.0 * rows * keys * G * D, name=name,
                hbm=kv_elem * page_bytes + n_scores * scopes.FLOAT_BYTES
                + sum(scopes.strict_bytes(t) for t in ts),
                eager=rows * keys * row + n_scores * 4
                + sum(t.numel() * t.element_size() for t in ts))


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
    if q.dtype not in DTYPE_CODES or v_pages.dtype != k_pages.dtype \
            or k_pages.dtype not in (q.dtype, torch.float32, *PAGE_CODES):
        raise ValueError(f"paged_attention: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}; need q of "
                         f"{list(DTYPE_CODES)} and both pages of q's dtype, "
                         f"fp32 or one of {list(PAGE_CODES)}")
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


def _instance(q, k_pages, design=None) -> str:
    """The name of the instance a call ran: q's dtype / the pages', then
    the design, and " paired" where a cluster reads the rows through the
    map over token pairs (``page_map``)."""
    name = f"{str(q.dtype)[6:]}/{str(k_pages.dtype)[6:]}"
    if design is not None:
        name += f" {design}"
    if design == "cluster" and \
            page_map(q.shape[3], q.shape[1], k_pages.element_size()) == "paired":
        name += " paired"
    return name


def _check_rounding(q, k_pages):
    if not rounds_weights(q, k_pages):
        raise ValueError(f"paged_attention: {k_pages.dtype} pages under a {q.dtype} "
                         "q round nothing: take paged_attention_partials")


def _check_f32(name, t):
    if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} must be "
                         "contiguous fp32 on a CUDA device")
