"""Plain PyTorch version of the paged-attention decode kernel, as
``repro.kernels.paged_attention.ref.paged_attention_ref``: it gathers the
pages into a contiguous cache and runs dense attention."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """q (B,KV,G,D); k/v_pages (P,page,KV,D); block_tables (B,max_blocks)
    page ids; lens (B,) inclusive index of the newest token. Scores are
    scaled by D ** -0.5. Returns (B,KV,G,D)."""
    B, KV, G, D = q.shape
    page = k_pages.shape[1]
    max_blocks = block_tables.shape[1]
    tables = block_tables.long()
    kc = k_pages[tables].reshape(B, max_blocks * page, KV, D).float()
    vc = v_pages[tables].reshape(B, max_blocks * page, KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * D ** -0.5, kc)
    pos = torch.arange(max_blocks * page, device=q.device)
    valid = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    w = torch.where(l > 0, p / l.clamp_min(1e-30), 0.0)
    return torch.einsum("bkgs,bskd->bkgd", w, vc).to(q.dtype)
