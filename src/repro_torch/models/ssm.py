"""Mamba2 (SSD) blocks of the hybrid family, as ``repro.models.ssm``: the
chunked scan of a prompt and the O(1)-state decode step.

Projections are stored unpacked (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``),
with the JAX package's names and shapes. The prompt is scanned in chunks
of ``cfg.ssm.chunk`` tokens, the remainder as one more chunk, carrying the
state h (B, nh, hd, ds) in fp32 from chunk to chunk; inside a chunk the
work is batched products, so its memory is O(B * chunk^2 * nh). The JAX
package has no Pallas kernel here: the products are ``torch.matmul`` and
``einsum``, as it leaves them to XLA.

Under a ``ParallelContext`` with tp > 1 (``ctx=``) a layer is a rank's
shard, as the reference's ``MAMBA_AXES`` cut it: ``w_z``, ``w_x``,
``conv_x`` and ``gnorm`` hold the rank's d_inner channels, ``w_dt``,
``A_log``, ``D`` and ``dt_bias`` its heads (the same heads: channel c is
head c // head_dim), ``w_B``, ``w_C`` and their convs are whole, and
``out_proj`` holds the rank's rows. The rank scans its own heads from its
own slice of the state; the gated norm, an RMSNorm over the whole d_inner,
averages the ranks' mean squares with a ``psum`` over "model" before it
scales, and ``out_proj``'s partial product is summed by another.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis.scopes import Steps
from repro_torch.models.common import rmsnorm

ConvState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _dims(cfg, tp: int = 1) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state dim) of a Mamba2 layer, d_inner and
    heads those of one rank of ``tp``."""
    s = cfg.ssm
    di = s.expand * cfg.d_model // tp
    return di, di // s.head_dim, s.head_dim, s.d_state


def _tp(ctx) -> int:
    return 1 if ctx is None else ctx.tp


def _out(y: torch.Tensor, p, ctx) -> torch.Tensor:
    """``out_proj``, its row-parallel partial products summed over "model"."""
    y = y @ p["out_proj"]
    return y if _tp(ctx) == 1 else ctx.comm.psum(y, ctx.model_axis)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B,S,C); w (cw,C); state (B,cw-1,C), the
    previous inputs, or None for zeros. Returns (out (B,S,C), new state
    (B,cw-1,C): the last cw-1 inputs)."""
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    return out, (xp[:, -(cw - 1):] if cw > 1 else state)


def _project(x, p, conv_state: Optional[ConvState]):
    """The in-projections and short convs: z, the activated x, B and C,
    dt (fp32, softplus'd) and the new conv states."""
    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    Bc = x @ p["w_B"]
    Cc = x @ p["w_C"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    cs = conv_state if conv_state is not None else (None, None, None)
    xr, ns_x = _causal_conv(xr, p["conv_x"], cs[0])
    Bc, ns_B = _causal_conv(Bc, p["conv_B"], cs[1])
    Cc, ns_C = _causal_conv(Cc, p["conv_C"], cs[2])
    return z, F.silu(xr), F.silu(Bc), F.silu(Cc), dt, (ns_x, ns_B, ns_C)


def _chunk(h, xq, dtq, Bq, Cq, A):
    """One chunk of the scan. h (B,nh,hd,ds); xq (B,q,nh,hd); dtq (B,q,nh);
    Bq, Cq (B,q,ds), all fp32. Returns (h after the chunk, y (B,q,nh,hd))."""
    q = xq.shape[1]
    a = dtq * A                                                  # (B,q,nh) log-decay
    cum = torch.cumsum(a, dim=1)
    CB = torch.einsum("bqn,bpn->bqp", Cq, Bq)                    # (B,q,q)
    decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])   # (B,q,q,nh)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xq.device))
    decay = torch.where(tril[None, :, :, None], decay, 0.0)
    # the reference's einsum "bqp,bqph,bph,bphd->bqhd" with its three
    # scalar factors multiplied first to (B,q,q,nh): no (B,q,q,nh,hd) term
    w = CB[..., None] * decay * dtq[:, None, :, :]
    y_intra = torch.einsum("bqph,bphd->bqhd", w, xq)
    y_state = torch.einsum("bqn,bhdn->bqhd", Cq, h) * torch.exp(cum)[..., None]
    w_in = torch.exp(cum[:, -1:, :] - cum) * dtq                 # (B,q,nh)
    h_new = torch.exp(cum[:, -1, :])[:, :, None, None] * h \
        + torch.einsum("bqhd,bqn->bhdn", w_in[..., None] * xq, Bq)
    return h_new, y_intra + y_state


def mamba2_forward(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg, *,
                   initial_state: Optional[torch.Tensor] = None,
                   conv_state: Optional[ConvState] = None, ctx=None):
    """x (B,S,d) -> (y (B,S,d), (h (B,nh,hd,ds) fp32, conv states)); nh
    and the conv state of x a rank's under ``ctx``."""
    di, nh, hd, _ = _dims(cfg, _tp(ctx))
    B, S, _ = x.shape
    Q = min(cfg.ssm.chunk, S)
    z, xr, Bc, Cc, dt, new_cs = _project(x, p, conv_state)
    xh = xr.reshape(B, S, nh, hd).float()
    Bf, Cf = Bc.float(), Cc.float()
    A = -torch.exp(p["A_log"].float())                           # (nh,)
    h = initial_state if initial_state is not None \
        else init_mamba_state(cfg, B, x.dtype, x.device, tp=_tp(ctx))[0]
    chunks, ys = Steps(S // Q), []
    for c in chunks:               # whole chunks, then the remainder
        sl = slice(c * Q, (c + 1) * Q)
        h, y = _chunk(h, xh[:, sl], dt[:, sl], Bf[:, sl], Cf[:, sl], A)
        ys.append(y)
    ys = chunks.expand(ys)
    if S % Q:
        sl = slice(S - S % Q, S)
        h, y = _chunk(h, xh[:, sl], dt[:, sl], Bf[:, sl], Cf[:, sl], A)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gnorm"], cfg.norm_eps, ctx)
    return _out(y, p, ctx), (h, new_cs)


def mamba2_decode(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg,
                  state: Tuple[torch.Tensor, ConvState], ctx=None):
    """One token. x (B,1,d); state = (h (B,nh,hd,ds), conv states).
    Returns (y (B,1,d), new state)."""
    di, nh, hd, _ = _dims(cfg, _tp(ctx))
    B = x.shape[0]
    h, cs = state
    z, xr, Bc, Cc, dt, new_cs = _project(x, p, cs)
    dt = dt[:, 0]                                                # (B,nh)
    xh = xr.reshape(B, nh, hd).float()
    Bf = Bc[:, 0].float()                                        # (B,ds)
    Cf = Cc[:, 0].float()
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                                    # (B,nh)
    h_new = decay[:, :, None, None] * h \
        + (dt[:, :, None] * xh)[..., None] * Bf[:, None, None, :]
    y = torch.einsum("bn,bhdn->bhd", Cf, h_new)
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gnorm"], cfg.norm_eps, ctx)
    return _out(y, p, ctx), (h_new, new_cs)


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device="cpu",
                     tp: int = 1):
    """Zero state: h in fp32, the conv states in ``dtype``; h's heads and
    the conv state of x a rank's of ``tp``."""
    s = cfg.ssm
    di, nh, hd, ds = _dims(cfg, tp)
    h = torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device)
    cs = tuple(torch.zeros((batch, s.conv_width - 1, c), dtype=dtype,
                           device=device) for c in (di, ds, ds))
    return h, cs
