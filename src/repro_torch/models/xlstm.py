"""xLSTM blocks of the attention-free family, as ``repro.models.xlstm``:
mLSTM (matrix memory) and sLSTM (scalar memory, exponential gating).

Both are the exact fp32 recurrences with the stabiliser state m, run as a
Python loop over time, one step per token, as the JAX package's
``lax.scan``: a prompt is sequential by definition here (a parallel form
would round differently from the reference). The state of a sequence is
O(1): mLSTM (C (nh,hd,hd), n (nh,hd), m (nh,) in fp32, and the conv state
(3,di) in the model dtype) and sLSTM (c, n, h, m, each (d,) fp32).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import rmsnorm
from repro_torch.models.ssm import _causal_conv


def _mlstm_dims(cfg) -> Tuple[int, int, int]:
    di = 2 * cfg.d_model             # projection factor 2
    nh = cfg.n_heads
    return di, nh, di // nh


def mlstm_forward(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                  initial_state: Optional[Tuple[torch.Tensor, ...]] = None):
    """x (B,S,d) -> (x + y (B,S,d), (C, n, m, conv state)). The state
    passed in is not written."""
    B, S, d = x.shape
    di, nh, hd = _mlstm_dims(cfg)
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"]
    xm, og = up[..., :di], up[..., di:]
    conv_cs_in = initial_state[3] if initial_state is not None else None
    conv_out, conv_cs = _causal_conv(xm, p["conv"], conv_cs_in)
    conv_act = F.silu(conv_out)
    q = (conv_act @ p["w_q"]).reshape(B, S, nh, hd).float()
    k = ((conv_act @ p["w_k"]) * hd ** -0.5).reshape(B, S, nh, hd).float()
    v = (xm @ p["w_v"]).reshape(B, S, nh, hd).float()
    gates = (xm @ p["w_if"]).float()                             # (B,S,2nh)
    ig = gates[..., :nh]
    logf = F.logsigmoid(gates[..., nh:])                         # <= 0

    if initial_state is None:
        C, n, m, _ = init_mlstm_state(cfg, B, x.dtype, x.device)
    else:
        C, n, m = initial_state[:3]
    hs = []
    for t in range(S):
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
    h = torch.stack(hs, dim=1).reshape(B, S, di).to(x.dtype)
    h = rmsnorm(h, p["gnorm"], cfg.norm_eps) + conv_act @ p["skip"]
    y = (h * torch.sigmoid(og)) @ p["w_down"]
    return x + y, (C, n, m, conv_cs)


def mlstm_decode(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                 state: Tuple[torch.Tensor, ...]):
    """x (B,1,d); state (C, n, m, conv state (B,3,di)): one step of
    ``mlstm_forward``, which is the reference's decode step, but for m: the
    reference's ``mlstm_decode`` returns the m it was given, not the step's
    new one, and the port keeps that so that its tokens agree."""
    y, (C, n, _, conv) = mlstm_forward(x, p, cfg, initial_state=state)
    return y, (C, n, state[2], conv)


def slstm_forward(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                  initial_state: Optional[Tuple[torch.Tensor, ...]] = None):
    """x (B,S,d) -> (x + y (B,S,d), (c, n, h, m)). Fully sequential."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    wx = (xn @ p["w_gates"]).float()                             # (B,S,4d)
    c, n, h, m = initial_state if initial_state is not None \
        else init_slstm_state(cfg, B, x.device)
    R = p["r_gates"].float()                                     # (4,nh,hd,hd)
    hs = []
    for t in range(S):
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
    y = torch.stack(hs, dim=1).to(x.dtype)
    y = rmsnorm(y, p["gnorm"], cfg.norm_eps)
    ff = p["w_down"].shape[0]
    up = y @ p["w_up"]
    # jax.nn.gelu's default is the tanh form
    y = (F.gelu(up[..., :ff], approximate="tanh") * up[..., ff:]) @ p["w_down"]
    return x + y, (c, n, h, m)


def slstm_decode(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                 state: Tuple[torch.Tensor, ...]):
    return slstm_forward(x, p, cfg, initial_state=state)


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
