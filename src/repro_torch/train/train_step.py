"""The training step of ``repro.train.train_step`` for the port's model.

``make_prefill_step`` / ``make_decode_step`` of the reference serve its
dry-run lowering, which waits for the analysis slice; the port serves
through ``Transformer.prefill`` / ``decode_step`` and the engine.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.train.optimizer import AdamWConfig, apply_updates
from repro_torch.train.tree import leaves, unflatten


def make_train_step(model: Transformer, opt_cfg: AdamWConfig
                    ) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """``step(opt_state, batch) -> {"loss", "grad_norm", "lr"}``: the loss
    and its gradient with respect to every parameter, then one AdamW step
    that updates the model's parameters and ``opt_state`` in place. Turns
    the model's gradients on; the batch is ``loss_fn``'s."""
    params = model.param_tree()
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)

    def train_step(opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss = loss_fn(model, batch)
        # a parameter the loss does not read (Mamba2's ``norm``, as in the
        # reference) gets zeros, as under jax.grad
        grads = unflatten(params, list(torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)))
        metrics = apply_updates(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    return train_step
