"""Wrapper of the CUDA flash-attention prefill kernel
(``csrc/flash_attention.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. bf16 runs on the tensor-core (wgmma) instance, fp32 on the SIMT
instance (fp32 FMAs on the FP32 pipes); the dtype alone chooses. Both read
q, k and v through TMA tensor maps, so their bases must be 16-byte
aligned. Head dims 80, 112 and 120 run the bf16 instance on the 128
geometry, their pad columns zero-filled by TMA.
``causal`` picks the causal kernels (``csrc/flash_attention.cu``) or the
non-causal ones (``csrc/flash_attention_noncausal.cu``, the same source
compiled with the other mask into a library of its own), ``scale`` the
scores' scale. ``KERNEL.launches`` counts the causal launches,
``NONCAUSAL.launches`` the non-causal ones, each ``by_instance`` by q's
dtype (the bf16 or the fp32 instance).

On a meta tensor (``repro_torch.analysis``'s dry-run) the wrapper books
the kernel's products over the pairs it reads (causal or not, windowed)
and its I/O (q, k, v read once, the output written once) with the active
op counter, in the ``flash_core`` bucket the roofline replaces by the
analytic kernel I/O, and returns an empty meta result: it runs neither the
kernel nor its plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import scopes
from repro_torch.kernels.build import DTYPE_CODES, CudaKernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

__all__ = ["KERNEL", "NONCAUSAL", "flash_attention", "flash_attention_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
KERNEL = CudaKernel("flash_attention", "flash_attention_fwd", _ARGS)
NONCAUSAL = CudaKernel("flash_attention_noncausal", "flash_attention_noncausal_fwd",
                       _ARGS)
HEAD_DIMS = (32, 64, 80, 112, 120, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: Optional[torch.Tensor] = None, *, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """GQA prefill attention, the reference's ``flash_attention``. q
    (B,Sq,H,D); k,v (B,Skv,KV,D); lens (B,) int32 exclusive valid kv length
    (default Skv). Query row i sees key j < lens when j <= i (``causal``;
    with ``causal=False`` every such key) and, with a window > 0, when
    j > i - window. Scores are scaled by ``scale`` (default D ** -0.5).
    Returns (B,Sq,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens, causal=causal, window=window,
                                     scale=scale)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        _book(q, k, v, out, window, causal)
        return out
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if lens is None:
        lens = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    _check(q, k, v, lens)
    out = torch.empty_like(q)
    (KERNEL if causal else NONCAUSAL).launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, D, int(window), D ** -0.5 if scale is None else float(scale),
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        instance=str(q.dtype)[6:])
    return out


def causal_pairs(sq: int, skv: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs that count for one head of one sequence. Causal:
    the queries are the last ``sq`` of ``skv`` positions, each sees the keys
    at or before it, within the window. Non-causal (the kernel's query
    positions 0..sq-1): query i sees every key j < skv with j > i - window."""
    if not causal:
        first = np.maximum(np.arange(sq, dtype=np.int64) - window + 1, 0) \
            if window > 0 else np.zeros(sq, np.int64)
        return int(np.maximum(skv - first, 0).sum())
    reach = np.arange(skv - sq, skv, dtype=np.int64) + 1
    return int(np.minimum(reach, window).sum() if window > 0 else reach.sum())


def _book(q, k, v, out, window, causal=True):
    B, Sq, H, D = q.shape
    pairs = B * H * causal_pairs(Sq, k.shape[1], window, causal)
    ts = (q, k, v, out)
    scopes.book(flops=4.0 * pairs * D, scoped=True, name="flash_attention",
                hbm=sum(scopes.strict_bytes(t) for t in ts),
                eager=sum(t.numel() * t.element_size() for t in ts))


def _check(q, k, v, lens):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}, not cuda")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, _, H, D = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)} (need H % KV == 0)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; need one of {list(DTYPE_CODES)}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (B,):
        raise ValueError(f"flash_attention: lens must be int32 of shape ({B},)")
    for name, t in (("q", q), ("k", k), ("v", v), ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    # both instances read q, k and v through TMA tensor maps
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} ({t.dtype}) is not 16-byte aligned")
