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


def paged_attention_partials_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor, block_tables: torch.Tensor,
                                   lens: torch.Tensor, *, window: int = 0,
                                   part: int = 16):
    """The split half of the kernel: for each partition of ``part`` pages
    of the table, the fp32 (acc (B,KV,P,G,D), ml (B,KV,P,G,2)) of its
    softmax over the keys that count, ml = (m, l) with m the largest score
    and l the sum of exp(score - m), acc the sum of exp(score - m) * v; a
    partition with no key that counts holds (0, (NEG_INF, 0)). ``lens`` is
    the newest token's index counted from the table's first position and
    may lie outside the table; the window is applied to the same positions.
    P = ceil(max_blocks / part)."""
    B, KV, G, D = q.shape
    page = k_pages.shape[1]
    max_blocks = block_tables.shape[1]
    n_part = -(-max_blocks // part)
    n = max_blocks * page
    T = part * page                                   # tokens of a partition
    tables = block_tables.long()
    kc = k_pages[tables].reshape(B, n, KV, D).float()
    vc = v_pages[tables].reshape(B, n, KV, D).float()
    pad = n_part * T - n
    kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
    vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * D ** -0.5, kc)
    pos = torch.arange(n_part * T, device=q.device)
    newest = lens.long()[:, None]
    valid = (pos[None, :] <= newest) & (pos[None, :] < n)
    if window > 0:
        valid = valid & (pos[None, :] > newest - window)
    valid = valid[:, None, None, :].expand(B, KV, G, -1).reshape(B, KV, G, n_part, T)
    s = torch.where(valid, s.reshape(B, KV, G, n_part, T), NEG_INF)
    m = s.amax(dim=-1)                                              # (B,KV,G,P)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgpt,bptkd->bkpgd", p, vc.reshape(B, n_part, T, KV, D))
    ml = torch.stack([m, p.sum(dim=-1)], dim=-1).transpose(2, 3)     # (B,KV,P,G,2)
    return acc, ml.contiguous()


def paged_merge_plain(acc: torch.Tensor, ml: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Combine partitions: acc (B,KV,P,G,D), ml (B,KV,P,G,2) fp32 ->
    (B,KV,G,D) in ``dtype``: sum_p acc_p e^(m_p - M) / sum_p l_p e^(m_p -
    M), M the largest m_p; 0 where no key counted."""
    m, l = ml[..., 0], ml[..., 1]
    f = torch.exp(m - m.amax(dim=2, keepdim=True))                  # (B,KV,P,G)
    L = (l * f).sum(dim=2)
    A = (acc * f[..., None]).sum(dim=2)
    return torch.where(L[..., None] > 0, A / L.clamp_min(1e-30)[..., None],
                       0.0).to(dtype)
