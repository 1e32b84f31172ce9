"""Wrapper of the CUDA flash-attention prefill kernel
(``csrc/flash_attention.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. bf16 runs on the tensor-core (wgmma) instance, fp32 on the SIMT
instance; the dtype alone chooses. Head dims 80, 112 and 120 run the
bf16 instance on the 128 geometry, their pad columns zero-filled by TMA.
``KERNEL.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import DTYPE_CODES, CudaKernel
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

__all__ = ["KERNEL", "flash_attention", "flash_attention_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("flash_attention", "flash_attention_fwd",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
HEAD_DIMS = (32, 64, 80, 112, 120, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lens: Optional[torch.Tensor] = None, *,
                    window: int = 0) -> torch.Tensor:
    """Causal GQA prefill attention. q (B,Sq,H,D); k,v (B,Skv,KV,D);
    lens (B,) int32 exclusive valid kv length (default Skv). Returns
    (B,Sq,H,D) in q's dtype. Scores are scaled by D ** -0.5."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens, window=window)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if lens is None:
        lens = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    _check(q, k, v, lens)
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                  out.data_ptr(), B, Sq, Skv, H, KV, D, int(window),
                  D ** -0.5, DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


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
    if q.dtype == torch.bfloat16:
        # the wgmma instance reads q, k and v through TMA tensor maps
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: bf16 {name} is not 16-byte aligned")
