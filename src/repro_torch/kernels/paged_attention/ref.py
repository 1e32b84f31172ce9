"""Plain PyTorch version of the paged-attention decode kernel, as
``repro.kernels.paged_attention.ref.paged_attention_ref``: it gathers the
pages into a contiguous cache and runs dense attention, optionally over a
sliding window (which the Pallas kernel lacks; the JAX model applies it in
``decode_attention``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lens: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """q (B,KV,G,D); k/v_pages (P,page,KV,D); block_tables (B,max_blocks)
    page ids; lens (B,) inclusive index of the newest token. With a window
    > 0 the key at position ``pos`` counts when ``lens - window < pos <=
    lens``, as in ``repro.models.attention.decode_attention``. Scores are
    scaled by D ** -0.5. Returns (B,KV,G,D)."""
    B, KV, G, D = q.shape
    page = k_pages.shape[1]
    max_blocks = block_tables.shape[1]
    tables = block_tables.long()
    kc = k_pages[tables].reshape(B, max_blocks * page, KV, D).float()
    vc = v_pages[tables].reshape(B, max_blocks * page, KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * D ** -0.5, kc)
    pos = torch.arange(max_blocks * page, device=q.device)
    newest = lens.long()[:, None]
    valid = pos[None, :] <= newest
    if window > 0:
        valid = valid & (pos[None, :] > newest - window)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    w = torch.where(l > 0, p / l.clamp_min(1e-30), 0.0)
    return torch.einsum("bkgs,bskd->bkgd", w, vc).to(q.dtype)
