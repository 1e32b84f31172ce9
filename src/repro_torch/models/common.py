"""Shared numerics: RMSNorm and RoPE, as in ``repro.models.common``."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split. x: (..., S, H, D); positions: (..., S).
    Angles in fp32; an odd head_dim's last element passes through."""
    d = x.shape[-1]
    half = d // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freq                   # (..., S, half)
    ang = ang[..., None, :]                                     # head axis slot
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if d % 2:
        rot = torch.cat([rot, x[..., 2 * half:].float()], dim=-1)
    return rot.to(x.dtype)
