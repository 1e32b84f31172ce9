"""Plain PyTorch version of the paged-attention decode kernel, as
``repro.kernels.paged_attention.ref.paged_attention_ref``: it gathers the
pages into a contiguous cache and runs dense attention, optionally over a
sliding window (which the Pallas kernel lacks; the JAX model applies it in
``decode_attention``).

Pages of q's dtype, and pages upcast to q's (``upcast=True``, the
reference's ``decode_unroll``, ``src/repro/models/transformer.py:485-488``),
are attended in fp32. Pages of another dtype (a cache of
``kv_cache_dtype``) take ``repro.models.attention.decode_attention``'s
function: q*scale rounded to the pages' dtype, the normalised weights
exp(s - M) / L rounded to it, products summed in fp32 (``to_cache_dtype``
rounds as the reference does). fp32 pages round nothing, so they take the
fp32 path. Split over the sequence (a rank's share of its positions), that
function is two passes: ``paged_attention_stats_plain`` gives the share's
(m, l) and its scores, and ``paged_attention_values_plain``, given the
shares' (m, l) gathered (merged into the sequence's (M, L) by
``paged_stats_merge_plain``) and the share's scores, the share's sum of the
rounded weights times v, which ``paged_sum_plain`` adds up over the
shares."""
from __future__ import annotations

import torch

from repro_torch.models.cache_dtype import to_cache_dtype

NEG_INF = -1e30
# the relative error within which two computations of a softmax weight may
# differ (exp and sum orders differ by a few fp32 ulps); ``weight_slack``
# takes it
WEIGHT_REL = 2.0 ** -12
# int8 truncates every weight below 1 to 0, so only a row's largest weight
# can round to anything else: it is exactly 1 where one key holds the
# row's largest score and the other keys' sum s = sum exp(score - max)
# vanishes in the fp32 sum 1 + s (s below half an ulp of 1, 2^-24). Two
# computations may disagree on that only while s lies near 2^-24: each of
# a few hundred fp32 additions (tiles, lanes, partitions) may drop an
# addend below half an ulp, and exp differs by ``WEIGHT_REL``
INT8_EDGE = (2.0 ** -26, 2.0 ** -14)


def rounds_weights(q: torch.Tensor, k_pages: torch.Tensor, upcast: bool = False) -> bool:
    """Whether pages of ``k_pages``' dtype under ``q`` take
    ``decode_attention``'s function, which rounds q*scale and the
    normalised weights to the pages' dtype."""
    return not upcast and k_pages.dtype not in (q.dtype, torch.float32)


def _gathered(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """The table's pages as a dense fp32 cache (B, max_blocks*page, KV, D)."""
    B, nblk = block_tables.shape
    P, page, KV, D = pages.shape
    return pages[block_tables.long()].reshape(B, nblk * page, KV, D).float()


def _valid(lens: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """(B, n): the positions that count, lens - window < pos <= lens."""
    pos = torch.arange(n, device=lens.device)
    newest = lens.long()[:, None]
    valid = pos[None, :] <= newest
    if window > 0:
        valid = valid & (pos[None, :] > newest - window)
    return valid


def _exps(q, k_pages, block_tables, lens, window):
    """exp(s - M) (B,KV,G,n) in fp32 of decode_attention's scores from
    q*scale rounded to the pages' dtype, M each row's largest score; 0
    where a key does not count."""
    B, KV, G, D = q.shape
    kc = _gathered(k_pages, block_tables)
    qs = to_cache_dtype(q.float() * D ** -0.5, k_pages.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qs, kc)
    valid = _valid(lens, kc.shape[1], window)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    return torch.exp(s - s.amax(dim=-1, keepdim=True))


def decode_weights(q: torch.Tensor, k_pages: torch.Tensor, block_tables: torch.Tensor,
                   lens: torch.Tensor, window: int = 0) -> torch.Tensor:
    """decode_attention's normalised weights (B,KV,G,n) in fp32, from
    q*scale rounded to the pages' dtype, before their own rounding."""
    e = _exps(q, k_pages, block_tables, lens, window)
    return e / e.sum(dim=-1, keepdim=True)


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lens: torch.Tensor, *, window: int = 0,
                          upcast: bool = False) -> torch.Tensor:
    """q (B,KV,G,D); k/v_pages (P,page,KV,D); block_tables (B,max_blocks)
    page ids; lens (B,) inclusive index of the newest token. With a window
    > 0 the key at position ``pos`` counts when ``lens - window < pos <=
    lens``, as in ``repro.models.attention.decode_attention``. Scores are
    scaled by D ** -0.5. Pages of another dtype than q's take
    ``decode_attention``'s rounding unless ``upcast`` (the module
    docstring). Returns (B,KV,G,D) in q's dtype."""
    B, KV, G, D = q.shape
    if upcast:
        k_pages, v_pages = k_pages.to(q.dtype), v_pages.to(q.dtype)
    vc = _gathered(v_pages, block_tables)
    if rounds_weights(q, k_pages, upcast):
        w = decode_weights(q, k_pages, block_tables, lens, window)
        w = to_cache_dtype(w, v_pages.dtype).float()
        return torch.einsum("bkgs,bskd->bkgd", w, vc).to(q.dtype)
    kc = _gathered(k_pages, block_tables)
    s = torch.einsum("bkgd,bskd->bkgs", q.float() * D ** -0.5, kc)
    valid = _valid(lens, kc.shape[1], window)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    w = torch.where(l > 0, p / l.clamp_min(1e-30), 0.0)
    return torch.einsum("bkgs,bskd->bkgd", w, vc).to(q.dtype)


def weight_slack(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor, lens: torch.Tensor, *,
                 window: int = 0, upcast: bool = False) -> torch.Tensor:
    """How far two faithful computations of ``paged_attention_plain`` may
    lie apart, element by element (B,KV,G,D) fp32, where it rounds the
    weights to the pages' dtype: a weight known to within ``WEIGHT_REL``
    (exp and the sums differ by ulps between libraries and devices) may
    round to either neighbour when it lies that close to a rounding
    boundary (an e4m3 step is 1/8 to 1/16 of the weight), which moves the
    output by that step times |v|. int8's one boundary is 1, which only a
    row's largest weight reaches (``INT8_EDGE``). Zeros where nothing is
    rounded."""
    B, KV, G, D = q.shape
    if not rounds_weights(q, k_pages, upcast):
        return torch.zeros((B, KV, G, D), device=q.device)
    e = _exps(q, k_pages, block_tables, lens, window)
    if v_pages.dtype == torch.int8:
        top = e == 1.0
        rest = torch.where(top, 0.0, e).sum(dim=-1, keepdim=True)
        near = ((top.sum(dim=-1, keepdim=True) == 1) & (rest >= INT8_EDGE[0])
                & (rest <= INT8_EDGE[1]))
        step = (top & near).float()
    else:
        w = e / e.sum(dim=-1, keepdim=True)
        lo = to_cache_dtype(w * (1 - WEIGHT_REL), v_pages.dtype).float()
        hi = to_cache_dtype(w * (1 + WEIGHT_REL), v_pages.dtype).float()
        step = torch.nan_to_num((hi - lo).abs(), nan=0.0)
    return torch.einsum("bkgs,bskd->bkgd", step,
                        _gathered(v_pages, block_tables).abs())


def _partitioned_scores(qs, k_pages, block_tables, lens, window, part):
    """Scores of the fp32 queries ``qs`` (B,KV,G,D) against the table's
    keys cut into partitions of ``part`` pages: s (B,KV,G,P,T) with the
    keys that do not count at NEG_INF, and valid (B,KV,G,P,T). ``lens``
    counts from the table's first position and may lie outside it."""
    B, KV, G, D = qs.shape
    page = k_pages.shape[1]
    max_blocks = block_tables.shape[1]
    n_part = -(-max_blocks // part)
    n = max_blocks * page
    T = part * page                                   # tokens of a partition
    kc = torch.nn.functional.pad(_gathered(k_pages, block_tables),
                                 (0, 0, 0, 0, 0, n_part * T - n))
    s = torch.einsum("bkgd,bskd->bkgs", qs, kc)
    valid = _valid(lens, n_part * T, window) & (torch.arange(
        n_part * T, device=qs.device)[None, :] < n)
    valid = valid[:, None, None, :].expand(B, KV, G, -1).reshape(B, KV, G, n_part, T)
    return torch.where(valid, s.reshape(B, KV, G, n_part, T), NEG_INF), valid


def _partitioned_values(v_pages, block_tables, part):
    """The table's values cut as ``_partitioned_scores``' keys:
    (B,P,T,KV,D) fp32."""
    B, max_blocks = block_tables.shape
    page, KV, D = v_pages.shape[1:]
    n_part = -(-max_blocks // part)
    vc = torch.nn.functional.pad(_gathered(v_pages, block_tables),
                                 (0, 0, 0, 0, 0, (n_part * part - max_blocks) * page))
    return vc.reshape(B, n_part, part * page, KV, D)


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
    P = ceil(max_blocks / part). Pages of any dtype are attended in fp32
    (the upcast mode where they are not q's)."""
    D = q.shape[-1]
    s, valid = _partitioned_scores(q.float() * D ** -0.5, k_pages, block_tables,
                                   lens, window, part)
    m = s.amax(dim=-1)                                              # (B,KV,G,P)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgpt,bptkd->bkpgd", p,
                       _partitioned_values(v_pages, block_tables, part))
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


def paged_attention_stats_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                block_tables: torch.Tensor, lens: torch.Tensor, *,
                                window: int = 0):
    """Pass 1 of ``decode_attention``'s function over a share of each
    sequence (``lens`` counted from the table's first position, as
    ``paged_attention_partials_plain``'s): (ml, scores) in fp32, ml
    (B,KV,1,G,2) the share's (m, l) of the scores of q*scale rounded to the
    pages' dtype ((NEG_INF, 0) where no key counts), scores
    (B,KV,max_blocks,G,page) each page's scores, NEG_INF where a key does
    not count."""
    B, KV, G, D = q.shape
    nblk, page = block_tables.shape[1], k_pages.shape[1]
    qs = to_cache_dtype(q.float() * D ** -0.5, k_pages.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qs, _gathered(k_pages, block_tables))
    valid = _valid(lens, nblk * page, window)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    l = torch.where(valid, torch.exp(s - m[..., None]), 0.0).sum(dim=-1)
    scores = s.reshape(B, KV, G, nblk, page).transpose(2, 3).contiguous()
    return torch.stack([m, l], dim=-1)[:, :, None].contiguous(), scores


def paged_stats_merge_plain(ml: torch.Tensor) -> torch.Tensor:
    """Every entry's (m, l) of ml (B,KV,P,G,2) (shares or partitions)
    merged into the sequence's (M, L) (B,KV,G,2): M the largest m, L = sum
    l e^(m - M)."""
    m, l = ml[..., 0], ml[..., 1]
    M = m.amax(dim=2)
    return torch.stack([M, (l * torch.exp(m - M[:, :, None])).sum(dim=2)], dim=-1)


def paged_attention_values_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                                 lens: torch.Tensor, ml: torch.Tensor,
                                 scores: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Pass 2 over the same share: its fp32 sum (B,KV,1,G,D) of the
    weights exp(s - M) / L, rounded to the pages' dtype, times v; s the
    share's ``scores`` (pass 1's), (M, L) the sequence's, merged here from
    ``ml`` (B,KV,R,G,2), the R shares' (m, l) gathered in position order;
    zeros where no key of the share counts. q and the k pages give the
    shapes only."""
    B, KV, G, D = q.shape
    nblk, page = block_tables.shape[1], v_pages.shape[1]
    M, L = paged_stats_merge_plain(ml).unbind(dim=-1)                # (B,KV,G)
    s = scores.transpose(2, 3).reshape(B, KV, G, nblk * page)
    valid = _valid(lens, nblk * page, window)[:, None, None, :]
    w = torch.where(valid, torch.exp(s - M[..., None]) / L[..., None], 0.0)
    w = to_cache_dtype(w, v_pages.dtype).float()
    return torch.einsum("bkgs,bskd->bkgd", w, _gathered(v_pages, block_tables))[:, :, None]


def paged_sum_plain(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pass 2's sums (shares or partitions) added: acc (B,KV,P,G,D) ->
    (B,KV,G,D) in ``dtype``."""
    return acc.sum(dim=2).to(dtype)
