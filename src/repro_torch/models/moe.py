"""Token-choice top-k Mixture-of-Experts on one device, as the
single-device half of ``repro.models.moe``.

Dispatch is sort-based: assignments are sorted by expert (stable, so
first come first served within an expert), positions within each expert
come from an exclusive cumsum of the expert histogram, and tokens are
scattered into capacity-bounded ``(E, C, d)`` buffers. An assignment past
its expert's capacity is dropped: it gets the out-of-range slot ``E*C``.
Every expert runs on its whole buffer, so every expert's weights are read
whether or not a token reached it.

The router runs in fp32; the buffers, the expert products and the
combine stay in the model dtype, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x (T,d) -> softmax over experts (T,E), in fp32."""
    return torch.softmax(x.float() @ w_router.float(), dim=-1)


def _topk_assignments(probs: torch.Tensor,
                      top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top_k experts of each token and their renormalised weights."""
    w, idx = torch.topk(probs, top_k, dim=-1)
    return w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9), idx


def _dispatch_indices(flat_expert: torch.Tensor, n_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_expert (A,) -> slot (A,) in [0, E*C], keep (A,). A kept
    assignment's slot is expert * capacity + its arrival rank in that
    expert; a dropped one's is E*C."""
    A = flat_expert.shape[0]
    sorted_e, order = torch.sort(flat_expert, stable=True)
    counts = torch.bincount(flat_expert, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts                 # exclusive cumsum
    pos_in_e = torch.arange(A, device=flat_expert.device) - starts[sorted_e]
    keep_sorted = pos_in_e < capacity
    slot_sorted = torch.where(keep_sorted, sorted_e * capacity + pos_in_e,
                              n_experts * capacity)
    # back to assignment order: order is a permutation, so scatter inverts it
    slot = torch.empty_like(slot_sorted).index_put_((order,), slot_sorted)
    keep = torch.empty_like(keep_sorted).index_put_((order,), keep_sorted)
    return slot, keep


def _expert_ffn(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """buf (E,C,d); wg/wu (E,d,f); wd (E,f,d) -> (E,C,d)."""
    return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)


def _shared_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])) @ p["ws_down"]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a batch of ``n_tokens`` tokens."""
    m = cfg.moe
    return max(1, int(m.capacity_factor * n_tokens * m.top_k / m.n_experts))


def moe_ffn_reference(x: torch.Tensor, p: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> torch.Tensor:
    """x (T,d) -> (T,d), with capacity drops. ``p`` holds ``router``
    (d,E), ``we_gate``/``we_up`` (E,d,f), ``we_down`` (E,f,d) and, with
    shared experts, ``ws_gate``/``ws_up`` (d,fs), ``ws_down`` (fs,d)."""
    m = cfg.moe
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity(cfg, T)
    probs = router_probs(x, p["router"])
    # the profiler's ranges "moe_dispatch" and "moe_combine" hold the
    # bookkeeping around the router and expert products
    with record_function("moe_dispatch"):
        w, idx = _topk_assignments(probs, k)
        flat_w = w.reshape(-1)
        tok = torch.arange(T, device=x.device).repeat_interleave(k)
        slot, keep = _dispatch_indices(idx.reshape(-1), E, C)
        # one spare row takes every dropped assignment and is cut off: kept
        # slots are unique, so the buffer equals a scatter that drops them
        buf = x.new_zeros((E * C + 1, d))
        buf[slot] = x[tok] * keep[:, None].to(x.dtype)
    out_buf = _expert_ffn(buf[:E * C].view(E, C, d), p["we_gate"],
                          p["we_up"], p["we_down"]).view(E * C, d)
    with record_function("moe_combine"):
        # a dropped assignment reads the last row (the reference's gather
        # clamps its out-of-range index) with weight 0
        gathered = out_buf[slot.clamp(max=E * C - 1)]
        contrib = gathered * (flat_w * keep)[:, None].to(x.dtype)
        # the reference scatter-adds each token's k contributions into
        # zeros in assignment order; adding them in that order keeps its
        # roundings and, unlike an atomic index_add_ on the card, is
        # deterministic
        out = functools.reduce(torch.add, contrib.view(T, k, d).unbind(1))
    if m.n_shared_experts:
        out = out + _shared_ffn(x, p)
    return out


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """x (..., d) -> (..., d) over the flattened tokens. One device only:
    expert-parallel dispatch across a process group is not ported."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "moe_ffn: expert-parallel dispatch over more than one device is "
            "not ported; the port runs MoE layers on one device")
    shape = x.shape
    return moe_ffn_reference(x.reshape(-1, shape[-1]), p, cfg).reshape(shape)
