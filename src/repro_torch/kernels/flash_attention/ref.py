"""Plain PyTorch version of the flash-attention prefill kernel, as
``repro.kernels.flash_attention.ref.flash_attention_ref``: it materialises
the S x S scores, so it is for CPU runs and for checking the kernel."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: Optional[torch.Tensor] = None, *,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention. q (B,Sq,H,D); k,v (B,Skv,KV,D); lens (B,) exclusive
    valid kv length (default Skv). Query row i sees key j < lens when j <= i
    (``causal``; without it every such key) and, with a window > 0, when
    j > i - window. Scores are scaled by ``scale`` (default D ** -0.5).
    Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    if lens is None:
        lens = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    qf = q.float() * (D ** -0.5 if scale is None else scale)
    kf = k.repeat_interleave(g, dim=2).float()
    vf = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    valid = k_pos < lens.long()[:, None, None, None]
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window and window > 0:
        valid = valid & (k_pos > q_pos - window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    w = torch.where(l > 0, p / l.clamp_min(1e-30), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)
