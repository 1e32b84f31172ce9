"""Attention in plain PyTorch, as in ``repro.models.attention``.

``flash_prefill`` — causal (optionally sliding-window) GQA attention over a
prompt, with absolute ``q_positions`` and an exclusive valid kv length.
``decode_attention`` — one-token attention against a dense cache, where
``lens`` is the inclusive index of the newest token.

These are the functions the CUDA kernels (``repro_torch.kernels``) are held
against; the model calls the kernels' wrappers, never these.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor,
                  kv_lens: Optional[torch.Tensor] = None,
                  window: int = 0) -> torch.Tensor:
    """q (B,Sq,H,D); k,v (B,Skv,KV,D); H % KV == 0 (q head h reads kv head
    h // (H/KV)). q_positions (B,Sq) or (1,Sq); kv_lens (B,) exclusive valid
    length of k/v (defaults to Skv). Scores are scaled by D ** -0.5.
    Returns (B,Sq,H,D) in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    g = H // KV
    if kv_lens is None:
        kv_lens = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    qg = (q.float() * D ** -0.5).to(q.dtype).float().reshape(B, Sq, KV, g, D)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float())
    kv_pos = torch.arange(Skv, device=q.device)
    qp = q_positions.long()[:, None, None, :, None]               # (B|1,1,1,Sq,1)
    valid = kv_pos <= qp
    valid = valid & (kv_pos < kv_lens.long()[:, None, None, None, None])
    if window and window > 0:
        valid = valid & (kv_pos > qp - window)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype).float(), v.float())
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q (B,1,H,D); caches (B,S,KV,D); lens (B,) = index of the newest token
    (attention covers positions 0..lens inclusive); scores are scaled by
    D ** -0.5. Returns (B,1,H,D)."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = (q.float() * D ** -0.5).to(k_cache.dtype).float().reshape(B, KV, g, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(S, device=q.device)
    newest = lens.long()[:, None]
    valid = pos[None, :] <= newest
    if window and window > 0:
        valid = valid & (pos[None, :] > newest - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)
