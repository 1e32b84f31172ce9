"""Shared numerics: RMSNorm, RoPE and the training loss, as in
``repro.models.common``."""
from __future__ import annotations

from typing import Optional

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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Cross-entropy with a z-loss, as the reference's: logits (..., V),
    labels (...); an fp32 log-sum-exp around the detached max, ``nll +
    z_loss * lse**2``, and with ``mask`` the masked mean over
    ``max(sum(mask), 1)``. The label's logit is gathered, where the
    reference contracts a one-hot: the same value without a (T,V) one-hot."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if z_loss:
        nll = nll + z_loss * lse.square()
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
