"""xLSTM blocks of the attention-free family, as ``repro.models.xlstm``:
mLSTM (matrix memory) and sLSTM (scalar memory, exponential gating).

Both are the exact fp32 recurrences with the stabiliser state m, run as a
Python loop over time, one step per token, as the JAX package's
``lax.scan``: a prompt is sequential by definition here (a parallel form
would round differently from the reference). The state of a sequence is
O(1): mLSTM (C (nh,hd,hd), n (nh,hd), m (nh,) in fp32, and the conv state
(3,di) in the model dtype) and sLSTM (c, n, h, m, each (d,) fp32).

Under a ``ParallelContext`` with tp > 1 (``ctx=``) a block is a rank's
shard, as the reference's ``MLSTM_AXES`` and ``SLSTM_AXES`` cut it, and its
recurrence runs whole on every rank, whose state is whole, as the
reference's decode state is replicated over "model". The mLSTM's ``w_up``
holds a contiguous slice of its (x_m | output gate) columns, so its
product is gathered over "model"; the rank convolves its slice of x_m's
channels (``conv``) and multiplies its slices of the activations by its
rows of ``w_q``, ``w_k``, ``w_v``, ``w_if`` and ``skip``, and one ``psum``
adds the five partial products. The sLSTM's ``w_up`` is gathered the same
way, and the rank's slice of its gated product meets its rows of
``w_down`` before a ``psum``. So each block makes two collectives, both
outside the loop over tokens.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis.scopes import Steps
from repro_torch.models.common import rmsnorm
from repro_torch.models.ssm import _causal_conv, _tp


def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    di = 2 * cfg.d_model             # projection factor 2
    nh = cfg.n_heads
    return di, nh, di // nh


def _gather_up(up: torch.Tensor, ctx) -> torch.Tensor:
    """A column-parallel up-projection's product, whole on every rank."""
    return up if _tp(ctx) == 1 else ctx.comm.all_gather(up, ctx.model_axis, -1)


def _mlstm_inputs(xm, p, conv_cs_in, ctx):
    """q, k (unscaled), v, the gate logits and the skip product of the
    whole x_m, and the new conv state. Under tp > 1 from the rank's
    channels of x_m and one ``psum`` of the partial products."""
    c = p["conv"].shape[1]
    first = 0 if _tp(ctx) == 1 else ctx.comm.axis_index(ctx.model_axis) * c
    mine = slice(first, first + c)      # all of x_m's channels at tp=1
    xm_mine = xm[..., mine]
    conv_out, conv_cs = _causal_conv(
        xm_mine, p["conv"], None if conv_cs_in is None else conv_cs_in[..., mine])
    conv_act = F.silu(conv_out)
    parts = [conv_act @ p["w_q"], conv_act @ p["w_k"], xm_mine @ p["w_v"],
             xm_mine @ p["w_if"], conv_act @ p["skip"]]
    if _tp(ctx) == 1:
        return (*parts, conv_cs)
    # the state is whole on every rank: the last cw-1 inputs of all of x_m
    cw = p["conv"].shape[0]
    if conv_cs_in is None:
        conv_cs_in = xm.new_zeros((xm.shape[0], cw - 1, xm.shape[2]))
    conv_cs = torch.cat([conv_cs_in, xm], dim=1)[:, -(cw - 1):]
    whole = ctx.comm.psum(torch.cat(parts, dim=-1), ctx.model_axis)
    return (*whole.split([t.shape[-1] for t in parts], dim=-1), conv_cs)


def mlstm_forward(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                  initial_state: Optional[Tuple[torch.Tensor, ...]] = None,
                  ctx=None):
    """x (B,S,d) -> (x + y (B,S,d), (C, n, m, conv state)). The state
    passed in is not written."""
    B, S, d = x.shape
    di, nh, hd = _mlstm_dims(cfg)
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = _gather_up(xn @ p["w_up"], ctx)
    xm, og = up[..., :di], up[..., di:]
    conv_cs_in = initial_state[3] if initial_state is not None else None
    q, k, v, gates, skip, conv_cs = _mlstm_inputs(xm, p, conv_cs_in, ctx)
    q = q.reshape(B, S, nh, hd).float()
    k = (k * hd ** -0.5).reshape(B, S, nh, hd).float()
    v = v.reshape(B, S, nh, hd).float()
    gates = gates.float()                                        # (B,S,2nh)
    ig = gates[..., :nh]
    logf = F.logsigmoid(gates[..., nh:])                         # <= 0

    if initial_state is None:
        C, n, m, _ = init_mlstm_state(cfg, B, x.dtype, x.device)
    else:
        C, n, m = initial_state[:3]
    hs, tokens = [], Steps(S)
    for t in tokens:
        qt, kt, vt, it = q[:, t], k[:, t], v[:, t], ig[:, t]
        lm = logf[:, t] + m
        m_new = torch.maximum(lm, it)
        fp = torch.exp(lm - m_new)
        ip = torch.exp(it - m_new)
        # out of place: autograd keeps each step's C for the backward
        outer = vt[..., :, None] * kt[..., None, :]
        C = fp[..., None, None] * C + ip[..., None, None] * outer
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(num / den)
    h = torch.stack(tokens.expand(hs), dim=1).reshape(B, S, di).to(x.dtype)
    h = rmsnorm(h, p["gnorm"], cfg.norm_eps) + skip
    y = (h * torch.sigmoid(og)) @ p["w_down"]
    return x + y, (C, n, m, conv_cs)


def mlstm_decode(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                 state: Tuple[torch.Tensor, ...], ctx=None):
    """x (B,1,d); state (C, n, m, conv state (B,3,di)): one step of
    ``mlstm_forward``, which is the reference's decode step, but for m: the
    reference's ``mlstm_decode`` returns the m it was given, not the step's
    new one, and the port keeps that so that its tokens agree."""
    y, (C, n, _, conv) = mlstm_forward(x, p, cfg, initial_state=state, ctx=ctx)
    return y, (C, n, state[2], conv)


def slstm_forward(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                  initial_state: Optional[Tuple[torch.Tensor, ...]] = None,
                  ctx=None):
    """x (B,S,d) -> (x + y (B,S,d), (c, n, h, m)). Fully sequential."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    wx = (xn @ p["w_gates"]).float()                             # (B,S,4d)
    c, n, h, m = initial_state if initial_state is not None \
        else init_slstm_state(cfg, B, x.device)
    R = p["r_gates"].float()                                     # (4,nh,hd,hd)
    hs, tokens = [], Steps(S)
    for t in tokens:
        wxt = wx[:, t]
        rec = torch.einsum("ghij,bhj->gbhi", R, h.reshape(B, nh, hd)).reshape(4, B, d)
        zt = torch.tanh(wxt[:, :d] + rec[0])
        it = wxt[:, d:2 * d] + rec[1]
        ft = wxt[:, 2 * d:3 * d] + rec[2]
        ot = torch.sigmoid(wxt[:, 3 * d:] + rec[3])
        lm = F.logsigmoid(ft) + m
        m_new = torch.maximum(lm, it)
        fp = torch.exp(lm - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(tokens.expand(hs), dim=1).to(x.dtype)
    y = rmsnorm(y, p["gnorm"], cfg.norm_eps)
    up = _gather_up(y @ p["w_up"], ctx)
    ff = up.shape[-1] // 2
    # this rank's rows of w_down: all of them at tp=1
    f = p["w_down"].shape[0]
    first = 0 if _tp(ctx) == 1 else ctx.comm.axis_index(ctx.model_axis) * f
    # jax.nn.gelu's default is the tanh form
    y = (F.gelu(up[..., first:first + f], approximate="tanh")
         * up[..., ff + first:ff + first + f]) @ p["w_down"]
    if _tp(ctx) > 1:
        y = ctx.comm.psum(y, ctx.model_axis)
    return x + y, (c, n, h, m)


def slstm_decode(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                 state: Tuple[torch.Tensor, ...], ctx=None):
    return slstm_forward(x, p, cfg, initial_state=state, ctx=ctx)


def init_mlstm_state(cfg, batch: int, dtype=torch.float32, device="cpu"):
    """Zero state: C, n, m in fp32, the conv state in ``dtype``."""
    di, nh, hd = _mlstm_dims(cfg)
    return (torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
            torch.zeros((batch, nh), dtype=torch.float32, device=device),
            torch.zeros((batch, 3, di), dtype=dtype, device=device))


def init_slstm_state(cfg, batch: int, device="cpu"):
    """c, n, h, m (B,d) fp32; n starts at ones."""
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)  # noqa: E731
    return z(), torch.ones((batch, d), dtype=torch.float32, device=device), z(), z()
