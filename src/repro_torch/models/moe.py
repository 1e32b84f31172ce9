"""Token-choice top-k Mixture-of-Experts, as ``repro.models.moe``: on one
device, and expert-parallel over a process group (``moe_ffn`` with a
``ParallelContext``, the reference's ``shard_map`` split and replicated
dispatch).

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
    # bincount's length depends on the values, which a meta tensor lacks
    counts = torch.zeros(n_experts, dtype=flat_expert.dtype,
                         device=flat_expert.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
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
        out = _combine(out_buf[slot.clamp(max=E * C - 1)], flat_w, keep, k)
    if m.n_shared_experts:
        out = out + _shared_ffn(x, p)
    return out


def _combine(gathered: torch.Tensor, flat_w: torch.Tensor, keep: torch.Tensor,
             k: int) -> torch.Tensor:
    """Each token's k weighted expert outputs, added in assignment order
    (the reference's scatter-add into zeros; deterministic, unlike an
    atomic ``index_add_`` on the card)."""
    contrib = gathered * (flat_w * keep)[:, None].to(gathered.dtype)
    T = contrib.shape[0] // k
    return functools.reduce(torch.add, contrib.view(T, k, -1).unbind(1))


# the dimension of each expert leaf that the FSDP axis cuts: d_model by
# default, d_ff under ``moe_ff_shard`` (the reference's ``_moe_specs``)
_FSDP_DIMS = {"we_gate": 1, "we_up": 1, "we_down": 2,
              "ws_gate": 0, "ws_up": 0, "ws_down": 1}
_FF_DIMS = {"we_gate": 2, "we_up": 2, "we_down": 1,
            "ws_gate": 1, "ws_up": 1, "ws_down": 0}


def _gather_fsdp(p: Dict[str, torch.Tensor], ctx) -> Dict[str, torch.Tensor]:
    """The expert weights gathered over the axis that cuts them: the FSDP
    axis on d_model of ``we_gate``/``we_up`` (dim 1) and ``we_down`` (dim
    2), and of the shared experts' ``ws_gate``/``ws_up`` (dim 0) and
    ``ws_down`` (dim 1); under ``moe_ff_shard`` the "expert_ff" axis on
    their d_ff."""
    f = _ff_axis(ctx) or ctx.fsdp_axis
    if f is None:
        return p
    dims = _FF_DIMS if ctx.moe_ff_shard else _FSDP_DIMS
    return {k: ctx.comm.all_gather(v, f, dims[k], weights=True) if k in dims else v
            for k, v in p.items()}


def _ff_axis(ctx):
    """The mesh axis that cuts the experts' d_ff (``moe_ff_shard``), or None."""
    return ctx.spec("expert_ff")[0] if ctx.moe_ff_shard else None


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx=None) -> torch.Tensor:
    """x (..., d) -> (..., d) over the flattened tokens. Without a mesh,
    ``moe_ffn_reference``. Under a ``ParallelContext`` with a mesh (the
    reference's ``moe_ffn``), x is this rank's tokens (its "data" shard,
    replicated over "model"), ``p``'s expert leaves are its shards (E/tp
    experts; d_model cut over the FSDP axis, or d_ff under
    ``moe_ff_shard``) and the router is whole. ``ctx.moe_dispatch`` "auto"
    takes split dispatch where the tokens divide over "model", else
    replicated:

      * split: the expert weights gathered whole, each "model" rank routes
        its 1/tp of the tokens with a capacity of its slice,
        ``all_to_all`` sends each expert's buffer to its owner and the
        outputs back, and the ranks' tokens are gathered again;
      * replicated: every rank runs its own experts on every token, with
        a capacity over its E/tp experts, and a ``psum`` over "model"
        adds the ranks' outputs. Under ``moe_ff_shard`` no weight is
        gathered: the tokens of every rank of the d_ff axis are gathered
        instead, each rank's d_ff slice gives partial products of all of
        them (the SwiGLU acts elementwise on d_ff), routed and capped
        block by block as each rank's own tokens are, and a
        reduce-scatter over that axis adds the partials and keeps this
        rank's rows. That is the baseline's function; the reference's
        lever adds its partial products over ranks that hold other tokens
        (ROADMAP §3).
    """
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    if ctx is None or ctx.mesh is None:
        return moe_ffn_reference(xt, p, cfg).reshape(shape)
    m, comm, maxis = cfg.moe, ctx.comm, ctx.model_axis
    T, d = xt.shape
    tp = ctx.tp
    E, k = m.n_experts, m.top_k
    e_loc = E // tp
    mode = ctx.moe_dispatch
    if mode == "auto":
        mode = "split" if T % tp == 0 and T // tp > 0 else "replicated"
    me = comm.axis_index(maxis)
    ff = _ff_axis(ctx)
    if mode == "split" or ff is None:
        p = _gather_fsdp(p, ctx)
    if mode == "split":
        t_loc = T // tp
        xs = xt[me * t_loc:(me + 1) * t_loc]
        cap = max(1, int(m.capacity_factor * t_loc * k / E))
        with record_function("moe_dispatch"):
            w, idx = _topk_assignments(router_probs(xs, p["router"]), k)
            tok = torch.arange(t_loc, device=x.device).repeat_interleave(k)
            slot, keep = _dispatch_indices(idx.reshape(-1), E, cap)
            send = xs.new_zeros((E * cap + 1, d))
            send[slot] = xs[tok] * keep[:, None].to(xs.dtype)
            # recv[j]: peer j's tokens for my experts, (e_loc, cap, d) each
            recv = comm.all_to_all(send[:E * cap].view(tp, e_loc * cap, d), maxis)
            buf = recv.view(tp, e_loc, cap, d).transpose(0, 1) \
                      .reshape(e_loc, tp * cap, d)
        out_buf = _expert_ffn(buf, p["we_gate"], p["we_up"], p["we_down"])
        with record_function("moe_combine"):
            back = out_buf.view(e_loc, tp, cap, d).transpose(0, 1)
            back = comm.all_to_all(back, maxis).reshape(E * cap, d)
            out = _combine(back[slot.clamp(max=E * cap - 1)], w.reshape(-1),
                           keep, k)
        if m.n_shared_experts:
            out = out + _shared_ffn(xs, p)
        return comm.all_gather(out, maxis, 0).reshape(shape)
    # replicated: this rank's experts on every token, then a psum; under
    # moe_ff_shard over the n blocks of tokens of the d_ff axis's ranks
    n = 1 if ff is None else comm.size(ff)
    xa = xt if ff is None else comm.all_gather(xt, ff, 0)
    cap = max(1, int(m.capacity_factor * T * k / max(e_loc, 1)))
    with record_function("moe_dispatch"):
        w, idx = _topk_assignments(router_probs(xa, p["router"]), k)
        flat_e = idx.reshape(-1)
        tok = torch.arange(n * T, device=x.device).repeat_interleave(k)
        local = (flat_e >= me * e_loc) & (flat_e < (me + 1) * e_loc)
        # other ranks' assignments go to a spare expert e_loc, never run;
        # block j's experts are j * (e_loc + 1) + e, so each block fills
        # its own capacity
        block = torch.div(tok, T, rounding_mode="floor")
        slot, keep = _dispatch_indices(
            block * (e_loc + 1) + torch.where(local, flat_e - me * e_loc, e_loc),
            n * (e_loc + 1), cap)
        keep = keep & local
        rows = n * (e_loc + 1) * cap
        buf = xa.new_zeros((rows + 1, d))
        buf[slot] = xa[tok] * keep[:, None].to(xa.dtype)
        # (n, e_loc + 1, cap, d) -> each expert's rows of every block
        buf = buf[:rows].view(n, e_loc + 1, cap, d)[:, :e_loc].transpose(0, 1) \
                        .reshape(e_loc, n * cap, d)
    out_buf = _expert_ffn(buf, p["we_gate"], p["we_up"], p["we_down"])
    with record_function("moe_combine"):
        out_buf = torch.cat([out_buf.view(e_loc, n, cap, d).transpose(0, 1),
                             out_buf.new_zeros((n, 1, cap, d))], 1).reshape(rows, d)
        out = _combine(out_buf[slot.clamp(max=rows - 1)], w.reshape(-1), keep, k)
    out = comm.psum(out, maxis)
    if m.n_shared_experts:
        out = out + _shared_ffn(xa, p)
    if ff is not None:
        out = comm.reduce_scatter(out, ff, 0)
    return out.reshape(shape)
