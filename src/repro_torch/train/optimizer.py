"""AdamW, as ``repro.train.optimizer`` on one device: a global-norm clip,
a linear warmup, bias corrections, decoupled weight decay on every leaf,
and the moments ``m`` and ``v`` kept in ``state_dtype`` (fp32 by default;
bf16 halves their memory).

It is a plain function under ``torch.no_grad`` rather than
``torch.optim.AdamW``, which keeps its moments in the parameter's dtype
and has neither the global clip nor the warmup. Every scalar of the
schedule is an fp32 tensor on the parameters' device, as the reference
computes it in fp32, so a step never waits for the host.

The state is ``{"m": tree, "v": tree, "step": int32}`` with the trees
keyed as the parameters (``Transformer.param_tree``), so a checkpoint's
keys read ``1/m/<path>`` as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: torch.dtype = torch.float32


def init_opt_state(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa: E731
                                  device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """``lr * min(step / warmup, 1)`` in fp32."""
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree: Any) -> torch.Tensor:
    """The fp32 norm over every leaf, summed leaf by leaf in tree order."""
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in leaves(tree)))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, opt_state: Dict[str, Any],
                  cfg: AdamWConfig) -> Dict[str, torch.Tensor]:
    """One AdamW step. Writes the new parameters into ``params`` and the new
    ``m``, ``v`` and ``step`` into ``opt_state``, in place; returns
    ``{"grad_norm", "lr"}``. Each leaf's arithmetic is the reference's in
    fp32, in its order: the update uses the fp32 moments and stores them
    rounded to ``state_dtype``; leaf by leaf, so the temporaries are a few
    times the largest leaf."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        g = g.float() * scale
        m_new = m.float() * cfg.b1
        m_new += g * (1 - cfg.b1)
        v_new = v.float() * cfg.b2
        v_new += g.square_() * (1 - cfg.b2)
        m.copy_(m_new)
        v.copy_(v_new)
        delta = m_new.div_(b1c).div_(v_new.div_(b2c).sqrt_().add_(cfg.eps))
        delta += cfg.weight_decay * p.float()
        p.copy_(p.float().sub_(delta.mul_(lr)))
    opt_state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
