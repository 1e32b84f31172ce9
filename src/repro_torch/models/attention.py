"""Attention in plain PyTorch, as in ``repro.models.attention``.

``flash_prefill`` — causal (optionally sliding-window) GQA attention over a
prompt, with absolute ``q_positions`` and an exclusive valid kv length.
``decode_attention`` — one-token attention against a dense cache, where
``lens`` is the inclusive index of the newest token.

These two are the functions the CUDA kernels (``repro_torch.kernels``) are
held against. Serving (``prefill``, ``decode_step``) calls the kernels'
wrappers; the full-sequence ``Transformer.forward`` of training calls
``flash_prefill`` under autograd, as the reference's train mode calls its
jnp ``flash_prefill`` and neither Pallas kernel, which have no backward.
Its scores and softmax are tagged ``flash_core`` for the dry-run's op
counter, as the reference tags them with ``jax.named_scope``: the
roofline replaces their bytes by the kernel's own I/O.

``mla_*`` — Multi-Head Latent Attention (DeepSeek-R1): prefill, the
*absorbed* decode whose cache is the (kv_rank + rope) latent of each token,
and that decode over a paged latent pool, whole or split over the ranks
that each hold a share of every sequence's positions (``mla_partials``,
``mla_merge``, ``mla_absorb``). The JAX package has no kernel for them
either; the model calls these.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.scopes import scope
from repro_torch.models.cache_dtype import to_cache_dtype
from repro_torch.models.common import rmsnorm, rope

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
    with scope("flash_core"):
        qg = (q.float() * D ** -0.5).to(q.dtype).float().reshape(B, Sq, KV, g, D)
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, k.float())
        kv_pos = torch.arange(Skv, device=q.device)
        qp = q_positions.long()[:, None, None, :, None]           # (B|1,1,1,Sq,1)
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
    D ** -0.5; q*scale and the weights are rounded to the caches' dtype as
    the reference rounds them (``to_cache_dtype``). Returns (B,1,H,D)."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = to_cache_dtype(q.float() * D ** -0.5, k_cache.dtype).float().reshape(B, KV, g, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(S, device=q.device)
    newest = lens.long()[:, None]
    valid = pos[None, :] <= newest
    if window and window > 0:
        valid = valid & (pos[None, :] > newest - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", to_cache_dtype(p, v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------- MLA
def mla_scale(ml) -> float:
    return (ml.qk_nope_head_dim + ml.qk_rope_head_dim) ** -0.5


def _mla_q(x, p, cfg, positions):
    """Query of every head, split into its no-rope and roped parts."""
    ml = cfg.mla
    cq = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    qs = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"])
    q_pe = rope(qs[..., ml.qk_nope_head_dim:], positions, cfg.rope_theta)
    return qs[..., :ml.qk_nope_head_dim], q_pe


def mla_latents(x, p, cfg, positions):
    """The decode cache entries of x (B,S,d) at positions (B|1,S): the
    normed latent ckv (B,S,kv_rank) and the roped key kpe (B,S,rope)."""
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    kpe = rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return ckv, kpe


def mla_prefill(x, p, cfg, positions, kv_lens=None):
    """x (B,S,d), already normed; positions (S,) or (B|1,S); kv_lens (B,)
    exclusive valid length. Returns (out (B,S,d), (ckv, kpe)), the latents
    being the decode cache. Scores are formed in x's dtype, masked and
    soft-maxed in fp32, and the weights cast back to x's dtype before the
    value product, as in the reference. Materialises (B,H,S,S) scores."""
    ml = cfg.mla
    S = x.shape[1]
    qp = positions.reshape(1, S) if positions.ndim == 1 else positions
    q_nope, q_pe = _mla_q(x, p, cfg, qp)
    ckv, kpe = mla_latents(x, p, cfg, qp)
    k_nope = torch.einsum("bsr,rhe->bshe", ckv, p["w_uk"])
    vv = torch.einsum("bsr,rhe->bshe", ckv, p["w_uv"])
    s = (torch.einsum("bqhe,bkhe->bhqk", q_nope, k_nope)
         + torch.einsum("bqhe,bke->bhqk", q_pe, kpe)) * mla_scale(ml)
    s = s.float()
    kpos = torch.arange(S, device=x.device)
    valid = kpos[None, None, :] <= qp.long()[:, :, None]
    if kv_lens is not None:
        valid = valid & (kpos[None, None, :] < kv_lens.long()[:, None, None])
    s = torch.where(valid[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhe->bqhe", w, vv)
    out = torch.einsum("bqhe,hed->bqd", ctx, p["w_o"])
    return out, (ckv, kpe)


def mla_query(x, p, cfg, lens):
    """The absorbed decode's query of each head: x (B,1,d), already normed,
    at positions ``lens`` (B,) -> q_lat (B,1,H,kv_rank) (``w_uk`` absorbed)
    and the roped q_pe (B,1,H,rope)."""
    q_nope, q_pe = _mla_q(x, p, cfg, lens.long()[:, None])
    return torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"]), q_pe


def mla_absorb(ctx_lat, p):
    """The latent context (B,H,kv_rank) of each head through ``w_uv`` and
    ``w_o`` -> (B,1,d)."""
    ctx = torch.einsum("bhr,rhe->bhe", ctx_lat, p["w_uv"])         # absorb w_uv
    return torch.einsum("bhe,hed->bd", ctx, p["w_o"])[:, None, :]


def mla_partials(q_lat, q_pe, ckv_pool, kpe_pool, block_tables, lens, scale):
    """The absorbed decode's softmax over the share of each sequence's
    positions that ``block_tables`` (B,nb) holds in the paged latent pools
    ckv (P,page,kv_rank) and kpe (P,page,rope): ``lens`` (B,) is the newest
    token's index counted from the share's first position, and may lie past
    its end (every position counts) or before its start (none does).
    q_lat (B,1,H,kv_rank), q_pe (B,1,H,rope). Scores are formed in the
    queries' dtype, as ``mla_decode`` forms them; the rest is fp32: returns
    (acc (B,H,kv_rank), the sum of exp(s - m) * ckv; m (B,H), the largest
    score, NEG_INF where no position counts; l (B,H), the sum of
    exp(s - m))."""
    ckv, kpe = _latents(ckv_pool, kpe_pool, block_tables, q_lat.dtype)
    s = ((torch.einsum("bshr,btr->bhst", q_lat, ckv)
          + torch.einsum("bshe,bte->bhst", q_pe, kpe)) * scale).float()[:, :, 0]
    t = torch.arange(ckv.shape[1], device=q_lat.device)
    valid = (t[None, :] <= lens.long()[:, None])[:, None, :]       # (B,1,T)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("bht,btr->bhr", e, ckv.float()), m, e.sum(dim=-1)


def mla_merge(acc, m, l, dtype):
    """Merge the partials of the shares along dim 1 (acc (B,n,H,kv_rank),
    m and l (B,n,H)) -> the latent context (B,H,kv_rank) in ``dtype``:
    sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), M the largest m_i."""
    f = torch.exp(m - m.amax(dim=1, keepdim=True))
    L = (l * f).sum(dim=1)
    return ((acc * f[..., None]).sum(dim=1)
            / L.clamp_min(1e-30)[..., None]).to(dtype)


def mla_decode(x, p, cfg, ckv_cache, kpe_cache, lens):
    """Absorbed MLA decode. x (B,1,d), already normed; caches (B,S,kv_rank)
    and (B,S,rope) holding the new token at ``lens`` (B,), the inclusive
    index of the newest token. Returns (B,1,d)."""
    ml = cfg.mla
    pos = lens.long()
    q_lat, q_pe = mla_query(x, p, cfg, lens)
    s = (torch.einsum("bshr,btr->bhst", q_lat, ckv_cache)
         + torch.einsum("bshe,bte->bhst", q_pe, kpe_cache)) * mla_scale(ml)
    s = s.float()[:, :, 0, :]                                      # (B,H,S)
    t = torch.arange(ckv_cache.shape[1], device=x.device)
    valid = t[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    return mla_absorb(torch.einsum("bht,btr->bhr", w, ckv_cache), p)


def mla_decode_paged(x, p, cfg, ckv_pool, kpe_pool, block_tables, lens):
    """``mla_decode`` over a paged latent pool: ckv_pool (P,page,kv_rank),
    kpe_pool (P,page,rope); block_tables (B,max_blocks) page ids whose
    pages cover positions 0..lens (every entry a valid page). The table's
    pages are gathered into a dense cache (upcast to x's dtype where the
    pools are narrower, ``_latents``); positions past ``lens`` are
    masked."""
    ckv, kpe = _latents(ckv_pool, kpe_pool, block_tables, x.dtype)
    return mla_decode(x, p, cfg, ckv, kpe, lens)


def _latents(ckv_pool, kpe_pool, block_tables, dtype):
    """The table's pages of both latent pools as dense caches (B,n,r) in
    ``dtype``: a pool of a narrower cache dtype (bf16 under fp32, int8)
    upcast exactly, as the reference's einsums promote it."""
    B, nblk = block_tables.shape
    pages = block_tables.long()
    return tuple(pool[pages].reshape(B, nblk * pool.shape[1], -1).to(dtype)
                 for pool in (ckv_pool, kpe_pool))
