"""Contexts and inputs of every (arch x shape) dry-run cell, as
``repro.launch.specs``: one rank's tensors of a cell, on the meta device
for counting (or on a card for a cell that fits one), never the whole
mesh's.

``build_ctx`` reads the dry-run's ``opts`` as the reference does: the
batch over ("pod", "data") or "data"; a decode batch that does not divide
over them (long_500k's B 1) leaves the batch whole and cuts the cache
sequence over "data"; train cells remat by default. Every §Perf lever of
``opts`` goes into the context, and the model takes it, a ``kv_cache_dtype``
other than the model's included (its pools in that dtype).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ShapeSpec
from repro_torch.parallel.sharding import ParallelContext, mesh_axes

KV_CACHE_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16,
                   "fp8": torch.float8_e4m3fn}
PAGE = 16       # tokens per page of the paged pools (K2's page)


def build_ctx(mesh, multi_pod: bool, cfg: ModelConfig, shape: ShapeSpec,
              opts: Optional[Dict[str, Any]] = None) -> ParallelContext:
    """The reference's ``build_ctx`` over ``mesh`` (None: one device)."""
    opts = opts or {}
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    dp = 1 if mesh is None else int(np.prod(
        [mesh.shape[mesh.mesh_dim_names.index(a)] for a in batch_axes]))
    overrides: Dict[str, Any] = {}
    if shape.kind == "decode" and shape.global_batch % dp != 0:
        # long_500k (B=1): batch unshardable -> shard the cache sequence axis
        overrides.update({"batch": None, "cache_batch": None,
                          "cache_seq": "data"})
    overrides.update(opts.get("rules_override", {}))
    kv_dt = opts.get("kv_cache_dtype")
    if isinstance(kv_dt, str):
        kv_dt = KV_CACHE_DTYPES[kv_dt]
    return ParallelContext(
        mesh=mesh,
        batch_axes=batch_axes,
        fsdp_axis=opts.get("fsdp_axis", "data"),
        remat=opts.get("remat", "full" if shape.kind == "train" else "none"),
        kv_cache_dtype=kv_dt,
        moe_dispatch=opts.get("moe_dispatch", "auto"),
        rules_override=overrides or None,
        decode_unroll=bool(opts.get("decode_unroll")),
        serve_2d_tp=bool(opts.get("serve_2d_tp")),
        seq_parallel_norm=bool(opts.get("seq_parallel_norm")),
        moe_ff_shard=bool(opts.get("moe_ff_shard")),
        seq_shard_decode=bool(opts.get("seq_shard_decode")),
        train_kv_2d=bool(opts.get("train_kv_2d")),
    )


def parts(ctx: ParallelContext, logical: str) -> int:
    """How many ways ``ctx`` cuts a dimension with the logical axis."""
    if ctx.mesh is None:
        return 1
    return int(np.prod([ctx.axis_size(a) for a in mesh_axes(ctx.spec(logical)[0])]))


def _tok_lens(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[int, int]:
    """(token_len, prefix_len) so prefix+tokens == shape.seq_len."""
    p = cfg.frontend_prefix_len
    return shape.seq_len - p, p


def local_batch(shape: ShapeSpec, ctx: ParallelContext) -> int:
    """This rank's rows of the global batch."""
    return shape.global_batch // parts(ctx, "batch")


def cache_share(shape: ShapeSpec, ctx: ParallelContext) -> int:
    """The positions of each sequence this rank's decode cache holds."""
    return shape.seq_len // parts(ctx, "cache_seq")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, ctx: ParallelContext, model,
                device="meta", act_dtype=torch.bfloat16) -> Dict[str, Any]:
    """This rank's inputs of the cell for ``model`` (the rank's
    ``Transformer``): tokens (and labels, and a prefix of embeddings for a
    vlm or audio model) for train and prefill; for decode one new token a
    sequence at position seq_len - 1 against pools and block tables that
    hold the rank's share of ``seq_len`` positions (``decode_inputs``).
    Empty tensors on ``device`` (meta: shapes only)."""
    B = local_batch(shape, ctx)
    s_tok, s_pre = _tok_lens(cfg, shape)
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((B, s_tok), dtype=torch.long, device=device)}
        if shape.kind == "train":
            out["labels"] = torch.empty((B, s_tok), dtype=torch.long, device=device)
        if s_pre:
            out["prefix_embeds"] = torch.empty((B, s_pre, cfg.d_model),
                                               dtype=act_dtype, device=device)
        return out
    return decode_inputs(model, B, shape.seq_len, cache_share(shape, ctx),
                         ctx.kv_cache_dtype or model.dtype, device=device)


def decode_inputs(model, batch: int, seq_len: int, share: int, cache_dtype,
                  device="meta") -> Dict[str, Any]:
    """One decode step's arguments: tokens and positions (seq_len - 1) of
    ``batch`` sequences; ``model.pool_shapes`` pools of ``batch * share /
    16`` pages with identity block tables (sequence b's pages b*n ..
    b*n + n-1, n = share / 16); the recurrent state buffers of
    ``model.state_shapes(batch)`` and their rows."""
    n = share // PAGE
    pools: List[torch.Tensor] = [
        torch.empty(s, dtype=cache_dtype, device=device)
        for s in model.pool_shapes(batch * n, PAGE)]
    states = [torch.empty(s, dtype=dt, device=device)
              for s, dt in model.state_shapes(batch)]
    return {
        "tokens": torch.empty((batch,), dtype=torch.long, device=device),
        "positions": torch.full((batch,), seq_len - 1, dtype=torch.long, device=device),
        "pools": pools,
        "block_tables": torch.arange(batch * n, dtype=torch.int32,
                                     device=device).view(batch, n),
        "states": states,
        "rows": torch.arange(batch, device=device),
    }
