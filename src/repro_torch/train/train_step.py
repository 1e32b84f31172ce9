"""The steps of ``repro.train.train_step`` for the port's model: the
training step, and the serve steps the dry-run counts
(``repro_torch.launch.dryrun``); the engine serves through
``Transformer.prefill`` / ``decode_step`` itself.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.transformer import Transformer, loss_fn
from repro_torch.train.optimizer import AdamWConfig, apply_updates
from repro_torch.train.tree import leaves, unflatten


def loss_and_grads(model: Transformer, batch: Dict[str, torch.Tensor],
                   placements: Any = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``loss_fn`` and its gradient with respect to every parameter, in
    ``leaves(model.param_tree())`` order. Turns the model's gradients on.
    ``placements`` is ``model.placements()``, built here if not given.

    On a model sharded over a mesh (the reference's ``make_train_step(cfg,
    ctx)``) the batch is this rank's rows. A rank's gradient of a leaf is
    then its share: the collectives' transposes have added the shares over
    every mesh axis the leaf is cut over (an FSDP leaf's gather over
    "data" transposes to a reduce-scatter), so the shares are added here
    over each axis on which the leaf is whole ("data" for a leaf that FSDP
    does not cut, "model" for one that TP does not). Each rank then holds
    its shard of the one-device gradient. Without a mesh there is no axis
    and nothing to add."""
    flat = leaves(model.param_tree())
    for p in flat:
        p.requires_grad_(True)
    loss = loss_fn(model, batch)
    # a parameter the loss does not read (Mamba2's ``norm``, as in the
    # reference) gets zeros, as under jax.grad
    grads = list(torch.autograd.grad(loss, flat, allow_unused=True,
                                     materialize_grads=True))
    ctx = model.ctx
    placements = model.placements() if placements is None else placements
    with torch.no_grad():
        for i, place in enumerate(leaves(placements)):
            for axis in ctx.axis_names:
                if axis not in place.axes():
                    grads[i] = ctx.comm.psum(grads[i], axis)
    return loss.detach(), grads


def make_train_step(model: Transformer, opt_cfg: AdamWConfig
                    ) -> Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """``step(opt_state, batch) -> {"loss", "grad_norm", "lr"}``: the loss
    and its gradient with respect to every parameter (``loss_and_grads``),
    then one AdamW step that updates the model's parameters and
    ``opt_state`` in place. Turns the model's gradients on; the batch is
    ``loss_fn``'s. On a model sharded over a mesh the batch is this rank's
    rows and ``opt_state`` its ZeRO shards (``init_opt_state`` of its
    parameters), and the global norm counts each element once."""
    params = model.param_tree()
    placements = model.placements()

    def train_step(opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, grads = loss_and_grads(model, batch, placements)
        metrics = apply_updates(params, unflatten(params, grads), opt_state,
                                opt_cfg, placements, model.ctx.comm)
        metrics["loss"] = loss
        return metrics

    return train_step


def make_prefill_step(model: Transformer) -> Callable[..., Tuple[torch.Tensor, Any, Any]]:
    """``step(tokens, prefix_embeds=None) -> (next token (B,) int32,
    caches, states)``: ``Transformer.prefill`` and the argmax of its last
    logits (the reference's ``make_prefill_step``)."""

    def prefill_step(tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None):
        last, caches, states = model.prefill(tokens, prefix_embeds)
        return last.argmax(dim=-1).to(torch.int32), caches, states

    return prefill_step


def make_decode_step(model: Transformer) -> Callable[..., torch.Tensor]:
    """``step(tokens, positions, pools, block_tables, states=(), rows=None)
    -> next token (B,) int32``: one ``Transformer.decode_step`` against the
    pools and block tables the caller sized (the dry-run's cover
    ``seq_len`` positions through identity tables) and the argmax of its
    logits (the reference's ``make_decode_step``)."""

    def decode_step(tokens, positions, pools, block_tables, states=(), rows=None):
        logits = model.decode_step(tokens, positions, pools, block_tables, states, rows)
        return logits.argmax(dim=-1).to(torch.int32)

    return decode_step
