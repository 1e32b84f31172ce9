"""Decoder of the serving path: the dense and MoE families of
``repro.models.transformer`` in their serve layout at tp=1, and the vlm and
audio families, whose backbones are dense decoders that take their
frontend's embeddings as a prefix of the prompt (``prefill``'s
``prefix_embeds``).

Parameters keep the JAX package's names and shapes, so weights move between
the two unchanged (``repro_torch.models.bridge``): ``embed``, ``final_norm``
and, for an untied head, ``lm_head (d,V)``; stacked layers under
``dense_stack`` (every layer of a dense model, the first
``first_dense_layers`` of an MoE one) and ``moe_stack`` (the rest).

Attention is GQA — ``wq (d,H,hd)``, ``wk``/``wv (d,KV,hd)``,
``wo (H,hd,d)``, kv-major heads (q head h reads kv head h // (H/KV)), with
qk-norm (``qn``/``kn (hd,)``, rmsnorms of q and k before rope) where the
config has it and a sliding window where its attention is "swa" — or MLA,
DeepSeek's latent attention, whose cache is a ``kv_lora_rank`` latent and
a ``qk_rope_head_dim`` roped key per token. GQA prefill runs the CUDA
flash kernel and GQA decode the CUDA paged kernel, both with the window;
the paged pool keeps every page of a sequence, as the engine's accounting
does; MLA, the MoE FFN
(``models/moe.py``), the projections and the dense MLP are PyTorch ops, as
the JAX package leaves them to XLA outside any Pallas kernel.

The hybrid family (zamba2) is ``mamba_stack``, its Mamba2 layers stacked
(L, ...), and ``shared_attn``, one attention+MLP block whose weights every
group of ``attn_every`` layers runs first, each group with its own paged
cache; the attention goes through the same two kernels. The ssm family
(xLSTM) is ``mlstm_stack`` (groups, slstm_every - 1, ...) and
``slstm_stack`` (groups, ...): no attention and no pool. Their recurrent
state lives in slot buffers of ``state_shapes``; prefill returns each
layer's final state from its own pass, and a decode step reads and writes
the batch's rows of the buffers.

A model is built in one of the reference's two layouts. At tp=1 their
parameters are the same arrays; they differ in how GQA groups q heads. The
``serve`` layout is kv-major (above) and is the only one ``prefill`` and
``decode_step`` take. The ``train`` layout is g-major, as the reference's
``_flash_gqa`` groups them in ``mode="train"``: q head ``j*KV + k`` reads kv
head ``k``. ``forward`` runs whole sequences under autograd in either
layout, through the plain ``flash_prefill``, ``mla_prefill``,
``mamba2_forward`` and the xLSTM forwards, never the kernels, and
``loss_fn`` is the reference's training loss over it.

Under a ``ParallelContext`` with a mesh (``ctx=``) a model is one rank's
shard of either layout, as the reference's ``param_shardings`` cut it
(``param_axes`` through ``ctx.rules()``): q heads padded to hp; in the
serve layout kv heads tiled to kvp (``padded_heads``), in the train layout
the true kv heads whole on every rank (``kv_heads_exact``) and q slots
g-major, the pad slots last; heads, d_ff, experts, the Mamba2 d_inner and
heads, the xLSTM up-projections and the vocab (or an untied embedding's
d_model) cut over "model"; the weights' d_model axes cut over the FSDP axis
and gathered before use; the batch cut over "data". q/k/v and gate/up are
column-parallel, ``wo``/``w_o``, ``w_down`` and Mamba2's ``out_proj``
row-parallel with a ``psum`` over "model"; the tied embedding is a masked
lookup of the rank's rows and a ``psum``, and the logits are gathered over
"model". K1 and K2 run on the rank's own heads; with the cache sequence
cut over a mesh axis (the ``cache_seq`` rule, long_500k's B 1), each rank
holds a contiguous share of every sequence's positions in its pool and
decode runs K2's split half on it, gathers the partials over that axis and
merges them once (``_split_attention``). MLA keeps its heads on
"model" and its latent cache whole on every rank, or, cut along the
sequence, splits its absorbed decode the same way in plain PyTorch
(``_mla_split``: fp32 partials over the rank's positions, gathered and
merged once, then ``w_uv`` and ``w_o``); the MoE FFN is
expert-parallel (``models/moe.py``); Mamba2 scans its own heads and its
state slots hold them, and the xLSTM blocks run their recurrences whole on
every rank (``models/xlstm.py``). The seeded init draws what one device
draws and keeps the rank's shard, so every mesh shape holds the model of
tp=1. ``forward`` under a mesh takes the rank's rows of the batch, and
``loss_fn`` returns the global masked mean, whose gradient on each rank is
that rank's share (``repro_torch.parallel.collectives``).

The reference's §Perf levers are taken under a mesh, each in the
reference's layout: ``remat="full"`` recomputes each dense or MoE layer's
training forward in its backward (its ``_maybe_remat``); ``serve_2d_tp``
keeps a decode step's GQA, dense-MLP and head weights as their FSDP
shards and contracts over them (``_col_2d``, ``_row_2d``);
``seq_parallel_norm`` cuts the residual stream of whole sequences over
"model" along the sequence (padded to a multiple), gathering each block's
normed input and reduce-scattering its output; ``seq_shard_decode`` keeps
the true kv heads on every rank and cuts the cache's sequence over
"model"; ``train_kv_2d`` cuts the train layout's true kv projections on
d_model over ("data", "model") (``_kv_2d``); ``moe_ff_shard`` cuts the
experts' d_ff over "data" (``models/moe.py``); ``decode_unroll`` changes
nothing here but for a cache of another dtype, which it reads upcast to
the model's (below).

The decode cache's dtype is the reference's ``ctx.kv_cache_dtype`` (else
a runner's, else the model's; ``pool_dtype``): fp32, bf16, fp8 e4m3 or
int8 under a model of either float dtype. Its entries are cast as
``jnp.astype`` casts (``models/cache_dtype.py``), and K2 computes the
reference's ``decode_attention`` on such pages, rounding q*scale and the
normalised weights to the cache's dtype; under ``decode_unroll`` the
reference upcasts the cache to the model's dtype first (dense, vlm, audio
and MoE stacks with GQA), and so does K2 (``upcast``). MLA reads its
latent pools upcast to the model's dtype, the reference's promotion; it
refuses fp8, where the reference's ``mla_decode`` raises, and a cache
wider than the model, where the reference's ``decode_step`` raises (its
layer scan refuses the carry that ``mla_decode`` promotes against the
wider latents). The recurrent states stay in the model's dtype (their
conv windows included): the reference's prefill replaces its cache-dtype
state by one harvested in the model's dtype, and its decode promotes.

On the meta device (``seed=None``) a model is its rank's shapes alone, at
any width: the dry-run traces one rank's step on it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_attention, paged_attention_partials, paged_attention_stats,
    paged_attention_values, paged_merge, paged_sum)
from repro_torch.kernels.paged_attention.ref import rounds_weights
from repro_torch.models.attention import (flash_prefill, mla_absorb,
                                          mla_decode_paged, mla_latents,
                                          mla_merge, mla_partials, mla_prefill,
                                          mla_query, mla_scale)
from repro_torch.models.cache_dtype import (check_cache_dtype, to_cache_dtype,
                                            writable)
from repro_torch.models.common import rmsnorm, rope, token_xent
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import (init_mamba_state, mamba2_decode,
                                    mamba2_forward)
from repro_torch.models.xlstm import (_mlstm_dims, init_mlstm_state,
                                      init_slstm_state, mlstm_decode,
                                      mlstm_forward, slstm_decode,
                                      slstm_forward)
from repro_torch.parallel.sharding import (ParallelContext, Placement,
                                           kv_to_orig, mesh_axes, padded_heads,
                                           q_to_orig, shard_shape, shard_slices)

# name -> (shape, init, fan_in); init is "normal" (std 1/sqrt(fan_in)),
# "ones" or "zeros", as ``build_param_specs`` gives them
Spec = Tuple[Tuple[int, ...], str, int]
# a leaf's logical axis names, one per dimension (None: replicated)
Axes = Tuple[Optional[str], ...]
# the most elements one fp32 draw of ``init_weights`` holds (256 MiB)
INIT_CHUNK = 1 << 26
LAYOUTS = ("serve", "train")


def _attn_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    H = cfg.n_heads
    if cfg.attention == "mla":
        ml = cfg.mla
        qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
        r = ml.kv_lora_rank
        return {
            "w_dq": ((d, ml.q_lora_rank), "normal", d),
            "q_norm": ((ml.q_lora_rank,), "ones", 1),
            "w_uq": ((ml.q_lora_rank, H, qk), "normal", ml.q_lora_rank),
            "w_dkv": ((d, r), "normal", d),
            "kv_norm": ((r,), "ones", 1),
            "w_kr": ((d, ml.qk_rope_head_dim), "normal", d),
            "w_uk": ((r, H, ml.qk_nope_head_dim), "normal", r),
            "w_uv": ((r, H, ml.v_head_dim), "normal", r),
            "w_o": ((H, ml.v_head_dim, d), "normal", H * ml.v_head_dim),
            "attn_norm": ((d,), "ones", 1),
        }
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "attn_norm": ((d,), "ones", 1),
        "wq": ((d, H, hd), "normal", d),
        "wk": ((d, KV, hd), "normal", d),
        "wv": ((d, KV, hd), "normal", d),
        "wo": ((H, hd, d), "normal", H * hd),
    }
    if cfg.qk_norm:
        s["qn"] = ((hd,), "ones", 1)
        s["kn"] = ((hd,), "ones", 1)
    return s


def _mlp_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": ((d,), "ones", 1),
        "w_gate": ((d, f), "normal", d),
        "w_up": ((d, f), "normal", d),
        "w_down": ((f, d), "normal", f),
    }


def _moe_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, m = cfg.d_model, cfg.moe
    E, fe = m.n_experts, m.d_ff_expert
    s = {
        "mlp_norm": ((d,), "ones", 1),
        "router": ((d, E), "normal", d),
        "we_gate": ((E, d, fe), "normal", d),
        "we_up": ((E, d, fe), "normal", d),
        "we_down": ((E, fe, d), "normal", fe),
    }
    if m.n_shared_experts:
        fs = fe * m.n_shared_experts
        s["ws_gate"] = ((d, fs), "normal", d)
        s["ws_up"] = ((d, fs), "normal", d)
        s["ws_down"] = ((fs, d), "normal", fs)
    return s


def _mamba_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    ds, cw = s.d_state, s.conv_width
    return {
        "norm": ((d,), "ones", 1),
        "w_z": ((d, di), "normal", d),
        "w_x": ((d, di), "normal", d),
        "w_B": ((d, ds), "normal", d),
        "w_C": ((d, ds), "normal", d),
        "w_dt": ((d, nh), "normal", d),
        "conv_x": ((cw, di), "normal", cw),
        "conv_B": ((cw, ds), "normal", cw),
        "conv_C": ((cw, ds), "normal", cw),
        "A_log": ((nh,), "zeros", 1),
        "D": ((nh,), "ones", 1),
        "dt_bias": ((nh,), "zeros", 1),
        "gnorm": ((di,), "ones", 1),
        "out_proj": ((di, d), "normal", di),
    }


def _mlstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    di, nh, _ = _mlstm_dims(cfg)
    return {
        "norm": ((d,), "ones", 1),
        "w_up": ((d, 2 * di), "normal", d),
        "conv": ((4, di), "normal", 4),
        "w_q": ((di, di), "normal", di),
        "w_k": ((di, di), "normal", di),
        "w_v": ((di, di), "normal", di),
        "w_if": ((di, 2 * nh), "normal", di),
        "gnorm": ((di,), "ones", 1),
        "w_down": ((di, d), "normal", di),
        "skip": ((di, di), "normal", di),
    }


def slstm_ff(cfg: ModelConfig) -> int:
    return int(round(4 * cfg.d_model / 3 / 64)) * 64 or 64


def _slstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, nh = cfg.d_model, cfg.n_heads
    hd, ff = d // nh, slstm_ff(cfg)
    return {
        "norm": ((d,), "ones", 1),
        "w_gates": ((d, 4 * d), "normal", d),
        "r_gates": ((4, nh, hd, hd), "normal", hd),
        "gnorm": ((d,), "ones", 1),
        "w_up": ((d, 2 * ff), "normal", d),
        "w_down": ((ff, d), "normal", ff),
    }


def stack_depths(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The leading (layer) dims of each stack's parameters; () is a block
    stored once (zamba2's shared attention)."""
    if cfg.family == "hybrid":
        return {"shared_attn": (), "mamba_stack": (cfg.n_layers,)}
    if cfg.family == "ssm":
        groups = cfg.n_layers // cfg.slstm_every
        return {"mlstm_stack": (groups, cfg.slstm_every - 1),
                "slstm_stack": (groups,)}
    if cfg.moe is not None and cfg.moe.n_experts:
        nd = cfg.moe.first_dense_layers
        return {"dense_stack": (nd,), "moe_stack": (cfg.n_layers - nd,)}
    return {"dense_stack": (cfg.n_layers,), "moe_stack": (0,)}


def _stack_specs(cfg: ModelConfig, stack: str) -> Dict[str, Spec]:
    if stack in ("dense_stack", "shared_attn"):
        return {**_attn_specs(cfg), **_mlp_specs(cfg)}
    if stack == "moe_stack":
        return {**_attn_specs(cfg), **_moe_specs(cfg)}
    return {"mamba_stack": _mamba_specs, "mlstm_stack": _mlstm_specs,
            "slstm_stack": _slstm_specs}[stack](cfg)


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Flat names of the serve parameters, in initialisation order."""
    d, V = cfg.d_model, cfg.vocab
    specs: Dict[str, Spec] = {"embed": ((V, d), "normal", d),
                              "final_norm": ((d,), "ones", 1)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, V), "normal", d)
    for stack, lead in stack_depths(cfg).items():
        if all(lead):
            for name, (shape, init, fan_in) in _stack_specs(cfg, stack).items():
                specs[f"{stack}.{name}"] = ((*lead, *shape), init, fan_in)
    return specs


def _attn_axes(cfg: ModelConfig) -> Dict[str, Axes]:
    if cfg.attention == "mla":
        heads = (None, "heads", None)
        return {"w_dq": ("embed", None), "q_norm": (None,), "w_uq": heads,
                "w_dkv": ("embed", None), "kv_norm": (None,),
                "w_kr": ("embed", None), "w_uk": heads, "w_uv": heads,
                "w_o": ("heads", None, "embed"), "attn_norm": (None,)}
    return {"attn_norm": (None,), "wq": ("embed", "heads", None),
            "wk": ("embed", "kv_heads", None), "wv": ("embed", "kv_heads", None),
            "wo": ("heads", None, "embed"), "qn": (None,), "kn": (None,)}


_MLP_AXES: Dict[str, Axes] = {
    "mlp_norm": (None,), "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed")}
# the expert leaves, which ``moe_ffn`` gathers over the FSDP axis itself;
# under ``moe_ff_shard`` their d_ff is cut over "expert_ff" instead of
# their d_model (the reference's ``_moe_specs``)
_MOE_AXES: Dict[str, Axes] = {
    "mlp_norm": (None,), "router": (None, None),
    "we_gate": ("expert", "expert_in", None),
    "we_up": ("expert", "expert_in", None),
    "we_down": ("expert", None, "expert_in"),
    "ws_gate": ("embed", None), "ws_up": ("embed", None),
    "ws_down": (None, "embed")}
_MOE_FF_AXES: Dict[str, Axes] = {
    **_MOE_AXES,
    "we_gate": ("expert", None, "expert_ff"),
    "we_up": ("expert", None, "expert_ff"),
    "we_down": ("expert", "expert_ff", None),
    "ws_gate": (None, "expert_ff"), "ws_up": (None, "expert_ff"),
    "ws_down": ("expert_ff", None)}
EXPERT_LEAVES = ("we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")
# the leaves a decode step multiplies as FSDP shards under ``serve_2d_tp``
TWO_D_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


# the reference's MAMBA_AXES, MLSTM_AXES and SLSTM_AXES
# (``repro.models.ssm``, ``repro.models.xlstm``)
_MAMBA_AXES: Dict[str, Axes] = {
    "norm": ("embed",), "w_z": ("embed", "ssm_inner"),
    "w_x": ("embed", "ssm_inner"), "w_B": ("embed", None),
    "w_C": ("embed", None), "w_dt": ("embed", "ssm_heads"),
    "conv_x": (None, "ssm_inner"), "conv_B": (None, None),
    "conv_C": (None, None), "A_log": ("ssm_heads",), "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",), "gnorm": ("ssm_inner",),
    "out_proj": ("ssm_inner", "embed")}
_MLSTM_AXES: Dict[str, Axes] = {
    "norm": ("embed",), "w_up": ("embed", "ssm_inner"),
    "conv": (None, "ssm_inner"), "w_q": ("ssm_inner", None),
    "w_k": ("ssm_inner", None), "w_v": ("ssm_inner", None),
    "w_if": ("ssm_inner", None), "gnorm": (None,), "w_down": (None, "embed"),
    "skip": ("ssm_inner", None)}
_SLSTM_AXES: Dict[str, Axes] = {
    "norm": ("embed",), "w_gates": ("embed", None),
    "r_gates": (None, None, None, None), "gnorm": (None,),
    "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def heads_layout(cfg: ModelConfig, ctx: ParallelContext,
                 layout: str = "serve") -> Tuple[int, int]:
    """(hp, kvx): the q and kv head counts of ``layout`` under ``ctx`` (the
    reference's ``heads_layout``): q padded to hp; kv tiled to kvp in the
    serve layout, kept at the true count in the train layout, and in the
    serve layout under ``seq_shard_decode``, unless hp is no multiple of it
    (MHA: zero-padded to kvp); for MLA the true count, which must divide
    tp."""
    if cfg.attention == "mla":
        return cfg.n_heads, cfg.n_heads
    hp, kvp = padded_heads(cfg.n_heads, cfg.n_kv_heads, ctx.tp)
    if (layout == "serve" and not ctx.seq_shard_decode) or hp % cfg.n_kv_heads:
        return hp, kvp
    return hp, cfg.n_kv_heads


def _kv_exact(cfg: ModelConfig, ctx: Optional[ParallelContext], layout: str) -> bool:
    """Whether ``layout`` keeps the true kv heads whole on every rank (the
    train layout's, and the serve layout's under ``seq_shard_decode``)."""
    ctx = ctx or ParallelContext()
    return ((layout == "train" or ctx.seq_shard_decode) and cfg.attention != "mla"
            and cfg.family != "ssm"
            and heads_layout(cfg, ctx, layout)[1] == cfg.n_kv_heads)


def param_axes(cfg: ModelConfig, layout: str = "serve",
               ctx: Optional[ParallelContext] = None) -> Dict[str, Axes]:
    """The logical axes of each parameter of ``layout``, as the reference's
    ``build_param_specs(cfg, ctx, mode=layout)`` gives them (its
    ``param_pspecs`` maps them through ``rules()``). True kv heads take
    ``kv_heads_exact``, over ``embed_kv`` in the train layout (``train_kv_2d``
    cuts it over both mesh axes) and over ``embed`` in the serve layout;
    ``ctx`` tells whether MHA alignment pads them instead and which §Perf
    levers change the layout (``seq_shard_decode``, ``moe_ff_shard``)."""
    attn = _attn_axes(cfg)
    if _kv_exact(cfg, ctx, layout):
        kv_in = "embed_kv" if layout == "train" else "embed"
        attn["wk"] = attn["wv"] = (kv_in, "kv_heads_exact", None)
    ff_shard = ctx is not None and ctx.moe_ff_shard
    top: Dict[str, Axes] = {
        "embed": ("vocab", None) if cfg.tie_embeddings else (None, "d_tp"),
        "final_norm": (None,), "lm_head": ("embed", "vocab")}
    tables = {"dense_stack": {**attn, **_MLP_AXES},
              "shared_attn": {**attn, **_MLP_AXES},
              "moe_stack": {**attn, **(_MOE_FF_AXES if ff_shard else _MOE_AXES)},
              "mamba_stack": _MAMBA_AXES,
              "mlstm_stack": _MLSTM_AXES, "slstm_stack": _SLSTM_AXES}
    depths = stack_depths(cfg)
    out = {}
    for name in param_specs(cfg):
        stack, _, leaf = name.rpartition(".")
        if not stack:
            out[name] = top[name]
        else:
            out[name] = ("layers",) * len(depths[stack]) + tables[stack][leaf]
    return out


def padded_shapes(cfg: ModelConfig, ctx: ParallelContext,
                  layout: str = "serve") -> Dict[str, Tuple[int, ...]]:
    """Each parameter's whole shape under ``ctx``: the reference's
    ``build_param_specs(cfg, ctx, layout)`` shapes, q heads padded to hp
    and kv heads to ``heads_layout``'s count."""
    hp, kvx = heads_layout(cfg, ctx, layout)
    count = {"heads": hp, "kv_heads": kvx, "kv_heads_exact": kvx}
    specs = param_specs(cfg)
    return {name: tuple(count.get(a, n) for n, a in zip(specs[name][0], axes))
            for name, axes in param_axes(cfg, layout, ctx).items()}


def head_maps(cfg: ModelConfig, ctx: ParallelContext,
              layout: str = "serve") -> Dict[str, np.ndarray]:
    """Padded head slot -> the tp=1 model's head slot (-1: a zero slot) for
    the head axes of ``layout``. Serve: the reference's ``q_to_orig`` and
    ``kv_to_orig``. Train: its g-major ``_q_slot_to_orig``, whose slot
    j*KV + k holds the head that the tp=1 train layout holds in the same
    slot, so the pad slots come last; kv zero-padded only under MHA
    alignment. MLA pads nothing."""
    if cfg.attention == "mla" or cfg.family == "ssm":
        return {}
    hp, kvx = heads_layout(cfg, ctx, layout)
    kv = (kv_to_orig(kvx, cfg.n_heads, cfg.n_kv_heads)
          if kvx != cfg.n_kv_heads else np.arange(kvx))
    if layout == "serve":
        q = q_to_orig(hp, kvx, cfg.n_heads, cfg.n_kv_heads)
    else:
        q = np.where(np.arange(hp) < cfg.n_heads, np.arange(hp), -1)
    return {"heads": q, "kv_heads": kv, "kv_heads_exact": kv}


def take_shard(full: torch.Tensor, axes: Axes, cfg: ModelConfig,
               ctx: ParallelContext, coords: Dict[str, int],
               layout: str = "serve") -> torch.Tensor:
    """The rank at ``coords``'s shard of a leaf given at tp=1 (``full``,
    its unpadded shape): head axes mapped through ``head_maps`` (zeros in
    pad slots, kv replicas tiled), then every axis cut by ``rules()``."""
    maps = head_maps(cfg, ctx, layout)
    padded = [len(maps[a]) if a in maps else n for n, a in zip(full.shape, axes)]
    x = full
    for dim, (a, sl) in enumerate(zip(axes, shard_slices(padded, axes, ctx, coords))):
        if a in maps:
            idx = torch.from_numpy(maps[a][sl]).to(full.device)
            x = x.index_select(dim, idx.clamp(min=0))
            mask = (idx >= 0).to(x.dtype).reshape(
                [-1 if d == dim else 1 for d in range(x.ndim)])
            x = x * mask
        else:
            x = x.narrow(dim, sl.start, sl.stop - sl.start)
    return x


def check_supported(cfg: ModelConfig):
    """Raise unless the port can build ``cfg``: a dense, vlm, audio or MoE
    decoder with full, sliding-window or latent attention; a hybrid with an
    ssm config and a full-attention shared block every ``attn_every``
    layers; or an ssm (xLSTM) stack with an sLSTM block every
    ``slstm_every``."""
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        if cfg.attention in ("full", "swa", "mla"):
            return
        why = (f"attention {cfg.attention!r}: a {cfg.family} decoder needs "
               "full, sliding-window (GQA) or latent (MLA) attention")
    elif cfg.family == "hybrid":
        if (cfg.ssm is not None and cfg.attention == "full" and cfg.attn_every
                and cfg.n_layers % cfg.attn_every == 0):
            return
        why = ("a hybrid needs an ssm config, full attention in its shared "
               "block and n_layers a multiple of attn_every > 0")
    elif cfg.family == "ssm":
        if cfg.slstm_every and cfg.n_layers % cfg.slstm_every == 0:
            return
        why = ("an ssm (xLSTM) stack needs slstm_every > 0 dividing "
               "n_layers")
    else:
        why = f"family {cfg.family!r} is not ported"
    raise NotImplementedError(f"{cfg.name}: {why}")


def check_shardable(cfg: ModelConfig, ctx: ParallelContext, layout: str):
    """Raise unless the port can shard ``cfg`` under ``ctx``: no GQA train
    layout whose padded q heads are no multiple of the kv heads (the
    reference tiles kv there, and its g-major slots then read other heads
    than tp=1's), no serve layout whose decode cache is cut over more than
    one mesh axis (``cache_seq``: the split decode gathers its partials
    over one), and every sharded dimension dividing its mesh axes. Every
    §Perf lever is taken."""
    hp, kvx = heads_layout(cfg, ctx, layout)
    if (layout == "train" and cfg.attention != "mla" and cfg.family != "ssm"
            and cfg.n_kv_heads < cfg.n_heads and kvx != cfg.n_kv_heads):
        raise NotImplementedError(
            f"{cfg.name}: the train layout at tp {ctx.tp} pads {cfg.n_heads} "
            f"q heads to {hp}, no multiple of its {cfg.n_kv_heads} kv heads")
    if ctx.train_kv_2d and ctx.fsdp_axis is None:
        raise NotImplementedError(
            f"{cfg.name}: train_kv_2d cuts the kv projections over the FSDP "
            "axis and \"model\"; it needs an FSDP axis")
    seq_axis = ctx.spec("cache_seq")[0]
    if layout == "serve" and seq_axis is not None and not isinstance(seq_axis, str):
        raise NotImplementedError(
            f"{cfg.name}: a decode cache cut over {seq_axis!r}: the split "
            "decode gathers its partials over one mesh axis")
    axes = param_axes(cfg, layout, ctx)
    for name, shape in padded_shapes(cfg, ctx, layout).items():
        shard_shape(shape, axes[name], ctx)


def cache_dtype_of(cfg: ModelConfig, ctx: ParallelContext, dtype: torch.dtype,
                   cache_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The decode cache's dtype for a model of ``dtype``:
    ``ctx.kv_cache_dtype``, else ``cache_dtype``, else ``dtype``. Raises
    where the reference does not serve it: MLA with fp8, whose
    ``mla_decode`` einsum has no implicit promotion of float8_e4m3fn
    (``TypePromotionError``, ``src/repro/models/attention.py:171``), and
    MLA with a cache wider than the model (fp32 under bf16), where the
    reference's ``decode_step`` raises ``TypeError``: ``mla_decode``
    (``src/repro/models/attention.py:159``) promotes the layer's output
    against the wider latents, and the layer scan
    (``src/repro/models/transformer.py:669-674``) refuses a carry whose
    dtype the body changed. Its prefill builds such a cache; the first
    decode step fails."""
    cdt = ctx.kv_cache_dtype or cache_dtype or dtype
    if cdt != dtype:
        check_cache_dtype(cdt)
    if cfg.attention == "mla" and cdt == torch.float8_e4m3fn:
        raise NotImplementedError(
            f"{cfg.name}: MLA with a float8_e4m3fn cache: the reference's "
            "mla_decode raises TypePromotionError there (no implicit promotion of "
            "float8_e4m3fn, src/repro/models/attention.py:171)")
    if cfg.attention == "mla" and cdt.itemsize > dtype.itemsize:
        raise NotImplementedError(
            f"{cfg.name}: MLA with a {cdt} cache under a {dtype} model: the "
            "reference's decode_step raises TypeError there (mla_decode promotes "
            "against the wider latents, src/repro/models/attention.py:159, and the "
            "layer scan refuses the promoted carry, "
            "src/repro/models/transformer.py:669-674)")
    return cdt


class Transformer(nn.Module):
    """``seed`` fills the weights on the device from a ``torch.Generator``;
    ``seed=None`` leaves them uninitialised for a caller that loads them.
    ``layout`` is ``"serve"`` or ``"train"`` (the module docstring).

    ``ctx``, a ``ParallelContext`` over a ``DeviceMesh``, builds this
    rank's shard of the layout (the module docstring's last part); None,
    or a context without a mesh, is one device."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, seed: Optional[int] = 0,
                 layout: str = "serve", ctx: Optional[ParallelContext] = None):
        super().__init__()
        check_supported(cfg)
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
        self.ctx = ctx or ParallelContext()
        if self.ctx.mesh is not None:
            check_shardable(cfg, self.ctx, layout)
        dev = resolve_device(device)
        cache_dtype_of(cfg, self.ctx, dtype)
        self.cfg = cfg
        self.layout = layout
        self.specs = param_specs(cfg)
        self.mla = cfg.attention == "mla"
        self.window = cfg.swa_window if cfg.attention == "swa" else 0
        hp, kvx = heads_layout(cfg, self.ctx, layout)
        tp = self.ctx.tp
        # each parameter's logical axes in this layout
        self.axes = param_axes(cfg, layout, self.ctx)
        self.kv_exact = _kv_exact(cfg, self.ctx, layout)
        # this rank's q and kv heads (all of them on one device; the true
        # kv heads on every rank where the layout keeps them), and the kv
        # heads of its decode cache: all kvx under ``seq_shard_decode``,
        # whose cache is cut along the sequence instead
        self.n_q, self.n_kv = hp // tp, kvx if self.kv_exact else kvx // tp
        self.pool_kv = kvx if self.ctx.seq_shard_decode else self.n_kv
        shapes = {n: s for n, (s, _, _) in self.specs.items()}
        if self.ctx.mesh is not None:
            shapes = {n: shard_shape(s, self.axes[n], self.ctx)
                      for n, s in padded_shapes(cfg, self.ctx, layout).items()}
        stacks: Dict[str, Dict[str, nn.Parameter]] = {
            stack: {} for stack in stack_depths(cfg)}
        for name, shape in shapes.items():
            p = nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                             requires_grad=False)
            stack, _, leaf = name.rpartition(".")
            if stack:
                stacks[stack][leaf] = p
            else:
                setattr(self, name, p)
        for stack, params in stacks.items():
            setattr(self, stack, nn.ParameterDict(params))
        # (stack, index in it) of each layer of a dense or MoE model, in the
        # order the layers run
        self.layers = [] if cfg.family in ("hybrid", "ssm") else [
            (stack, i) for stack, (n,) in stack_depths(cfg).items()
            for i in range(n)]
        # the mesh axis the decode cache's sequence is cut over, if any
        self.seq_axis = self.ctx.spec("cache_seq")[0] if self.ctx.mesh is not None \
            else None
        # §Perf levers that change the computation (the others change the
        # layout alone, or nothing: ``decode_unroll``): the FSDP axis that
        # decode's products contract over in place of gathering weights
        # (``serve_2d_tp``), and whether the residual stream of whole
        # sequences is cut over "model" along the sequence
        # (``seq_parallel_norm``; GQA blocks only, as the reference's)
        f = self.ctx.fsdp_axis
        self.two_d = f if (self.ctx.serve_2d_tp and f is not None
                           and self.ctx.axis_size(f) > 1) else None
        self.seq_parallel = (self.ctx.seq_parallel_norm and tp > 1 and not self.mla
                             and cfg.family != "ssm")
        # ``train_kv_2d``: the train layout's true kv projections cut on d
        # over ("data", "model"), partial products summed over "model"
        self.kv_2d = (self.ctx.train_kv_2d and layout == "train" and self.kv_exact
                      and tp > 1)
        # ``decode_unroll``: the reference's unrolled decode reads a cache
        # of another dtype upcast to the model's (dense, vlm, audio and MoE
        # stacks with GQA; ``src/repro/models/transformer.py:485-488``)
        self.upcast = (self.ctx.decode_unroll and not self.mla
                       and cfg.family in ("dense", "vlm", "audio", "moe"))
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def param_tree(self) -> Dict[str, object]:
        """The parameters nested as the JAX package's params: a stack's
        under its name, the rest at the top."""
        tree: Dict[str, object] = {}
        for name, p in self.named_parameters():
            stack, _, leaf = name.rpartition(".")
            (tree.setdefault(stack, {}) if stack else tree)[leaf] = p
        return tree

    @torch.no_grad()
    def init_weights(self, seed: int):
        """Normal weights with std 1/sqrt(fan_in), norms ones (and the
        Mamba2 ``A_log`` and ``dt_bias`` zeros). Each weight is drawn in
        fp32 in consecutive pieces of its memory of at most ``INIT_CHUNK``
        elements (256 MiB), so the draws of a full-width MoE stack fit
        beside its weights on the card (at 5 layers, R1's ``we_gate`` alone
        is 7.5 G elements)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = dict(self.named_parameters())
        for name, (shape, init, fan_in) in self.specs.items():
            flat = params[name].view(-1)
            if init != "normal":
                flat.fill_(1.0 if init == "ones" else 0.0)
                continue
            if self.ctx.mesh is not None:
                self._init_shard(params[name], name, shape, fan_in, gen)
                continue
            for start in range(0, flat.numel(), INIT_CHUNK):
                piece = flat[start:start + INIT_CHUNK]
                piece.copy_(torch.randn(
                    piece.numel(), generator=gen, device=self.device,
                    dtype=torch.float32).div_(math.sqrt(fan_in)))

    def _init_shard(self, param: torch.Tensor, name: str, shape, fan_in: int,
                    gen: torch.Generator):
        """Under a mesh: the same draws as one device makes for the whole
        leaf of ``shape`` (so every mesh shape gets the model of tp=1),
        one layer at a time into a buffer of the model's dtype, of which
        this rank keeps its shard (``take_shard``) and frees the rest."""
        axes = self.axes[name]
        lead = sum(1 for a in axes if a == "layers")
        layers = int(np.prod(shape[:lead]))
        per = int(np.prod(shape[lead:]))
        total = int(np.prod(shape))
        pieces = (torch.randn(min(INIT_CHUNK, total - start), generator=gen,
                              device=self.device,
                              dtype=torch.float32).div_(math.sqrt(fan_in))
                  for start in range(0, total, INIT_CHUNK))
        coords = self.ctx.coords()
        carry = torch.empty(0, device=self.device)
        stacked = param.flatten(0, lead - 1) if lead else param[None]
        for layer in range(layers):
            buf = torch.empty(per, dtype=self.dtype, device=self.device)
            filled = 0
            while filled < per:
                if not carry.numel():
                    carry = next(pieces)
                n = min(per - filled, carry.numel())
                buf[filled:filled + n].copy_(carry[:n])
                carry, filled = carry[n:], filled + n
            full = buf.view(shape[lead:])
            shard = take_shard(full, axes[lead:], self.cfg, self.ctx, coords,
                               self.layout)
            stacked[layer].copy_(shard)
            del buf, full, shard

    def pool_dtype(self, cache_dtype: Optional[torch.dtype] = None) -> torch.dtype:
        """The pools' dtype: ``ctx.kv_cache_dtype``, else ``cache_dtype``
        (a runner's), else the model's (``cache_dtype_of``)."""
        return cache_dtype_of(self.cfg, self.ctx, self.dtype, cache_dtype)

    def pool_shapes(self, n_pages: int, page: int) -> List[Tuple[int, ...]]:
        """Shapes of the paged decode-cache pools: k and v
        (L,P,page,KV,hd) for GQA, with L the shared block's groups in a
        hybrid; ckv (L,P,page,kv_rank) and kpe (L,P,page,rope) for MLA;
        none for the ssm family."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return []
        L = cfg.n_layers
        if self.mla:
            return [(L, n_pages, page, cfg.mla.kv_lora_rank),
                    (L, n_pages, page, cfg.mla.qk_rope_head_dim)]
        if cfg.family == "hybrid":
            L = cfg.n_layers // cfg.attn_every
        shape = (L, n_pages, page, self.pool_kv, cfg.resolved_head_dim)
        return [shape, shape]

    def state_shapes(self, n_slots: int
                     ) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each recurrent-state buffer of ``n_slots``
        sequences: a layer axis, then the slot axis, then one sequence's
        state as ``init_mamba_state`` / ``init_mlstm_state`` /
        ``init_slstm_state`` give it. For a hybrid h (L,n,nh,hd,ds) fp32
        and the conv states of x, B and C (L,n,cw-1,width) in the model's
        dtype; for xLSTM the mLSTM C, n, m (fp32) and conv, over its blocks
        in the order they run, then the sLSTM c, n, h, m (G,n,d) fp32;
        none for the other families. The conv states stay in the model's
        dtype under any cache dtype: the reference allocates them in the
        cache's (``init_mamba_state(cfg, batch, cdt)``), but its prefill
        replaces them by states harvested in the model's dtype and its
        decode's ``_causal_conv`` promotes them to it, so its decode reads
        the model's dtype (ROADMAP §3)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            h, cs = init_mamba_state(cfg, 1, self.dtype, device="meta",
                                     tp=self.ctx.tp)
            per_layer = [(cfg.n_layers, t) for t in (h, *cs)]
        elif cfg.family == "ssm":
            (G, per), _ = stack_depths(cfg).values()
            per_layer = ([(G * per, t) for t in init_mlstm_state(
                cfg, 1, self.dtype, device="meta")]
                + [(G, t) for t in init_slstm_state(cfg, 1, device="meta")])
        else:
            return []
        return [((L, n_slots, *t.shape[1:]), t.dtype) for L, t in per_layer]

    # ------------------------------------------------------------ layers
    def _layer(self, stack: str, *i: int, keep: Sequence[str] = ()
               ) -> Dict[str, torch.Tensor]:
        """One layer's weights (a block stored once takes no index); the
        leaves in ``keep`` stay this rank's shards."""
        return self._gather_layer(stack, {k: v[i] for k, v in
                                          getattr(self, stack).items()}, keep)

    def _gather_layer(self, stack: str, p: Dict[str, torch.Tensor],
                      keep: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
        """Under FSDP each of one layer's weights gathered over the FSDP
        axis, but for the expert leaves, which ``moe_ffn`` gathers, and
        those in ``keep``."""
        if self.ctx.mesh is None:
            return p
        lead = len(stack_depths(self.cfg)[stack])
        return {k: v if k in EXPERT_LEAVES or k in keep else self._gathered(
            v, self.axes[f"{stack}.{k}"][lead:]) for k, v in p.items()}

    def _decode_keep(self) -> Tuple[str, ...]:
        """The leaves a decode step uses as their FSDP shards: under
        ``serve_2d_tp`` every GQA and dense-MLP product's."""
        return TWO_D_LEAVES if self.two_d else ()

    def placements(self) -> Dict[str, object]:
        """Each parameter's ``Placement`` on the mesh, nested as
        ``param_tree`` (the reference's ``param_pspecs``); every leaf
        whole without a mesh."""
        tree: Dict[str, object] = {}
        for name, p in self.named_parameters():
            stack, _, leaf = name.rpartition(".")
            entries = (self.ctx.spec(*self.axes[name]) if self.ctx.mesh is not None
                       else (None,) * p.ndim)
            (tree.setdefault(stack, {}) if stack else tree)[leaf] = Placement(entries)
        return tree

    def _gathered(self, w: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``w`` gathered over the FSDP axis on every dimension cut over it
        (the reference leaves these gathers to GSPMD). A dimension cut over
        the FSDP axis and "model" together (``train_kv_2d``'s ``embed_kv``)
        keeps this "model" rank's blocks (``_kv_2d``)."""
        f = self.ctx.fsdp_axis
        if self.ctx.mesh is None or f is None:
            return w
        for dim, entry in enumerate(self.ctx.spec(*axes)):
            if f in mesh_axes(entry):
                w = self.ctx.comm.all_gather(w, f, dim, weights=True)
        return w

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings (B,S,d). A vocab-sharded (tied) table is a
        masked lookup of this rank's rows and a psum over "model"; a
        d-sharded (untied) one a lookup and a gather of d over "model"."""
        ctx, table = self.ctx, self.embed
        vocab_axis, d_axis = ctx.spec(*self.axes["embed"]) \
            if ctx.mesh is not None else (None, None)
        if vocab_axis is not None:
            rows = table.shape[0]
            local = tokens - ctx.comm.axis_index(vocab_axis) * rows
            mine = (local >= 0) & (local < rows)
            x = table[local.clamp(0, rows - 1)] * mine[..., None].to(table.dtype)
            return ctx.comm.psum(x, vocab_axis)
        x = table[tokens]
        return x if d_axis is None else ctx.comm.all_gather(x, d_axis, x.ndim - 1)

    # the §Perf levers' products. Under ``serve_2d_tp`` a decode step's
    # weights stay cut over the FSDP axis: a column-parallel product (d_model
    # in) gathers the batch's rows over that axis, multiplies this rank's d
    # slice of them by its shard and reduce-scatters the partial sums back to
    # its rows; a row-parallel one (d_model out) multiplies every row by its
    # shard, adds over "model" and sends each rank its rows' d slices
    # (all_to_all). Under ``seq_parallel_norm`` the residual stream is this
    # rank's share of the sequence: a block's input is gathered over "model"
    # after its norm, and its row-parallel output reduce-scattered back.
    def _col_2d(self, h: torch.Tensor, *ws: torch.Tensor) -> List[torch.Tensor]:
        """h (B,1,d) this rank's rows; each w (d/n, ...) its FSDP shard ->
        h @ w (B,1,m) for each, their partial sums reduce-scattered at once."""
        a, comm = self.two_d, self.ctx.comm
        n = ws[0].shape[0]
        i = comm.axis_index(a)
        rows = comm.all_gather(h, a, 0)
        h = rows[..., i * n:(i + 1) * n].reshape(-1, n)
        parts = [h @ w.reshape(n, -1) for w in ws]
        out = comm.reduce_scatter(torch.cat(parts, -1).view(*rows.shape[:-1], -1), a, 0)
        return list(out.split([t.shape[-1] for t in parts], -1))

    def _row_2d(self, o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """o (B,1,m) this rank's rows; w (m, d/n) its shard -> (B,1,d),
        summed over "model"."""
        a, comm = self.two_d, self.ctx.comm
        n = comm.size(a)
        y = self._psum(comm.all_gather(o, a, 0) @ w)            # (n*B,1,d/n)
        B = o.shape[0]
        y = comm.all_to_all(y.reshape(n, B, -1), a)              # (n,B,d/n)
        return y.transpose(0, 1).reshape(B, 1, -1)

    def _seq_cut(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of x (B,S,d) along the sequence, S padded at
        its end to a multiple of the "model" size."""
        tp = self.ctx.tp
        n = -(-x.shape[1] // tp)
        x = F.pad(x, (0, 0, 0, n * tp - x.shape[1]))
        return x[:, self.ctx.comm.axis_index(self.ctx.model_axis) * n:][:, :n]

    def _seq_join(self, x: torch.Tensor, seq: int) -> torch.Tensor:
        """The whole sequence of ``_seq_cut`` shares, its pad dropped."""
        return self.ctx.comm.all_gather(x, self.ctx.model_axis, 1)[:, :seq]

    def _kv_2d(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``train_kv_2d``: w (n*c, KV, hd) holds this "model" rank's c rows
        of d for every coordinate j of the FSDP axis (rows block j*tp + m of
        the (data, model) cut, gathered over data); its product with h's
        matching columns, summed over "model" -> (B,S,KV*hd)."""
        ctx = self.ctx
        tp, m = ctx.tp, ctx.comm.axis_index(ctx.model_axis)
        n = ctx.axis_size(ctx.fsdp_axis)
        c = w.shape[0] // n
        cols = ((torch.arange(n, device=h.device)[:, None] * tp + m) * c
                + torch.arange(c, device=h.device)).flatten()
        return self._psum(h.index_select(-1, cols) @ w.reshape(w.shape[0], -1))

    def _qkv(self, x, p, positions, *, seq: Optional[int] = None,
             two_d: bool = False):
        """x (B,S,d); positions (B,S) or (1,S). q (B,S,H,hd), k/v (B,S,KV,hd).
        ``seq``: x is this rank's share of a sequence of ``seq`` tokens
        (``seq_parallel_norm``), gathered after the norm; ``two_d``: a
        decode step's ``serve_2d_tp`` products on FSDP shards."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        if seq is not None:
            h = self.ctx.comm.all_gather(h, self.ctx.model_axis, 1)
        B, S, d = h.shape
        if two_d:
            q, k, v = self._col_2d(h, p["wq"], p["wk"], p["wv"])
        else:
            q = h @ p["wq"].reshape(d, -1)
            k, v = ((self._kv_2d(h, p[n]) if self.kv_2d else h @ p[n].reshape(d, -1))
                    for n in ("wk", "wv"))
        q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
        if cfg.qk_norm:
            q = rmsnorm(q, p["qn"], cfg.norm_eps)
            k = rmsnorm(k, p["kn"], cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _psum(self, y):
        """Sum a row-parallel product's partial results over "model"."""
        return self.ctx.comm.psum(y, self.ctx.model_axis)

    def _row(self, y, *, seq: Optional[int] = None):
        """A row-parallel product's partial sums over "model" added: by a
        psum, or under ``seq_parallel_norm`` by a reduce-scatter to this
        rank's share of the sequence."""
        if seq is None:
            return self._psum(y)
        return self.ctx.comm.reduce_scatter(y, self.ctx.model_axis, 1)

    def _out(self, x, o, p, *, seq: Optional[int] = None, two_d: bool = False):
        B, S = o.shape[:2]
        o = o.reshape(B, S, -1)
        if two_d:
            return x + self._row_2d(o, p["wo"].reshape(o.shape[-1], -1))
        return x + self._row(o @ p["wo"].reshape(-1, self.cfg.d_model), seq=seq)

    def _mlp(self, x, p, *, seq: Optional[int] = None, two_d: bool = False):
        h = rmsnorm(x, p["mlp_norm"], self.cfg.norm_eps)
        if "router" in p:
            if seq is None:
                return x + moe_ffn(h, p, self.cfg, self.ctx)
            # the whole sequence, its pad dropped, so the router sees the
            # tokens (and capacities) of the baseline
            y = moe_ffn(self._seq_join(h, seq), p, self.cfg, self.ctx)
            return x + self._seq_cut(y)
        if two_d:
            g, u = self._col_2d(h, p["w_gate"], p["w_up"])
            return x + self._row_2d(F.silu(g) * u, p["w_down"])
        if seq is not None:
            h = self.ctx.comm.all_gather(h, self.ctx.model_axis, 1)
        return x + self._row(
            (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"], seq=seq)

    def _head(self, x, *, two_d: bool = False):
        """Final norm and the head: x (B,d) -> logits (B,V), gathered over
        the vocab's mesh axis."""
        h = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            logits = h @ self.embed.t()
        elif two_d:
            logits = self._col_2d(h[:, None], self.lm_head)[0][:, 0]
        else:
            logits = h @ self._gathered(self.lm_head, ("embed", None))
        if self.ctx.mesh is None:
            return logits
        return self.ctx.comm.all_gather(logits, self.ctx.spec("vocab")[0],
                                        logits.ndim - 1)

    def _read_kv(self, k, v):
        """The kv heads this rank's q slots read (the serve layout's slot s
        reads kv head s // (hp/KV)), where every rank holds the true kv
        heads (``seq_shard_decode``): a contiguous range where the slots
        group evenly over it, else one head a slot."""
        if not self.kv_exact or self.ctx.tp == 1:
            return k, v
        gp = self.n_q * self.ctx.tp // k.shape[2]
        first = self.ctx.comm.axis_index(self.ctx.model_axis) * self.n_q
        idx = [(first + i) // gp for i in range(self.n_q)]
        lo, n = idx[0], idx[-1] - idx[0] + 1
        if self.n_q % n == 0 and idx == [lo + i // (self.n_q // n)
                                         for i in range(self.n_q)]:
            return k[:, :, lo:lo + n].contiguous(), v[:, :, lo:lo + n].contiguous()
        sel = torch.tensor(idx, device=k.device)
        return k.index_select(2, sel), v.index_select(2, sel)

    def _gqa_prefill(self, x, p, positions, seq: Optional[int] = None):
        """One attention+MLP layer over whole prompts through K1; returns
        x and the layer's (k, v) with the kv heads of the decode cache."""
        q, k, v = self._qkv(x, p, positions, seq=seq)
        x = self._out(x, flash_attention(q, *self._read_kv(k, v), window=self.window),
                      p, seq=seq)
        if k.shape[2] < self.pool_kv:
            k, v = (self.ctx.comm.all_gather(t, self.ctx.model_axis, 2) for t in (k, v))
        return self._mlp(x, p, seq=seq), (k, v)

    def _gqa_decode(self, x, p, pool_k, pool_v, at, block_tables):
        """One attention+MLP layer for one token per sequence: writes the
        token's k and v into the pools at ``at`` (``_cache_slots``; the
        rows ``mine`` keeps, where it is given), then
        attends through K2, or through its split half where the cache's
        sequence is cut over ranks. Under ``seq_shard_decode`` every rank's
        pool holds every kv head (of its share of the sequence), so q is
        gathered over "model" for K2 and this rank's heads kept from its
        output."""
        B, hd = x.shape[0], self.cfg.resolved_head_dim
        pos, pages, offs, lens, mine, s0 = at
        two_d = self.two_d is not None
        q, a, b = self._qkv(x, p, pos[:, None], two_d=two_d)
        axis = self.ctx.model_axis
        heads = self.ctx.seq_shard_decode and self.ctx.tp > 1
        if heads:
            q = self.ctx.comm.all_gather(q, axis, 2)
            if a.shape[2] < self.pool_kv:
                a, b = (self.ctx.comm.all_gather(t, axis, 2) for t in (a, b))
        q = q.reshape(B, self.pool_kv, -1, hd)
        _put(pool_k, pages, offs, a[:, 0], mine)
        _put(pool_v, pages, offs, b[:, 0], mine)
        if self.seq_axis is None:
            o = paged_attention(q, pool_k, pool_v, block_tables, lens,
                                window=self.window, upcast=self.upcast)
        else:
            o = self._split_attention(q, pool_k, pool_v, block_tables, lens - s0)
        o = o.reshape(B, -1, hd)
        if heads:
            first = self.ctx.comm.axis_index(axis) * self.n_q
            o = o[:, first:first + self.n_q]
        x = self._out(x, o.reshape(B, 1, -1), p, two_d=two_d)
        return self._mlp(x, p, two_d=two_d)

    def _split_attention(self, q, pool_k, pool_v, block_tables, local_lens):
        """K2's split half over this rank's share of every sequence (its
        positions counted from the share's start, so the causal bound and
        the window fall where they do globally), the partials gathered
        over ``seq_axis`` (the ranks' partitions in position order) and
        merged once. Pages that ``decode_attention`` rounds to (the cache's
        dtype is not q's) split in two passes, since its weights are
        normalised by the whole sequence's (M, L): pass 1's (m, l) of each
        rank's share gathered, pass 2 (which merges them) on each rank's
        share with its pass 1 scores, the ranks' sums gathered and added:
        three launches a layer (``ops.split_design``'s cluster design, at
        every head dim and kv head count)."""
        local_lens = local_lens.to(torch.int32)
        if rounds_weights(q, pool_k, self.upcast):
            ml, scores = paged_attention_stats(q, pool_k, block_tables, local_lens,
                                               window=self.window)
            ml = self.ctx.comm.all_gather(ml, self.seq_axis, 2)
            acc = paged_attention_values(q, pool_k, pool_v, block_tables, local_lens, ml,
                                         scores, window=self.window)
            return paged_sum(self.ctx.comm.all_gather(acc, self.seq_axis, 2), q.dtype)
        acc, ml = paged_attention_partials(q, pool_k, pool_v, block_tables,
                                           local_lens, window=self.window,
                                           upcast=self.upcast)
        D = acc.shape[-1]
        both = self.ctx.comm.all_gather(torch.cat([acc, ml], dim=-1),
                                        self.seq_axis, 2)
        return paged_merge(both[..., :D].contiguous(), both[..., D:].contiguous(),
                           q.dtype)

    def _mla_split(self, h, p, pool_ckv, pool_kpe, block_tables, local_lens, lens):
        """The absorbed MLA decode over this rank's share of every sequence
        (``local_lens`` counted from the share's start): fp32 partials
        (``mla_partials``) gathered over ``seq_axis`` and merged once, then
        ``w_uv`` and ``w_o`` on this rank's heads. Where the sequence is cut
        over "model", which also cuts the heads, the queries of every head
        are gathered first (each rank's positions serve all heads) and the
        rank keeps its heads' contexts after the merge."""
        ctx = self.ctx
        q_lat, q_pe = mla_query(h, p, self.cfg, lens)
        heads = self.seq_axis == ctx.model_axis and ctx.tp > 1
        if heads:
            q_lat, q_pe = (ctx.comm.all_gather(t, ctx.model_axis, 2) for t in (q_lat, q_pe))
        acc, m, l = mla_partials(q_lat, q_pe, pool_ckv, pool_kpe, block_tables,
                                 local_lens, mla_scale(self.cfg.mla))
        parts = ctx.comm.all_gather(torch.cat([acc, m[..., None], l[..., None]], -1)[:, None],
                                    self.seq_axis, 1)
        lat = mla_merge(parts[..., :-2], parts[..., -2], parts[..., -1], h.dtype)
        if heads:
            n = lat.shape[1] // ctx.tp
            lat = lat[:, ctx.comm.axis_index(ctx.model_axis) * n:][:, :n]
        return mla_absorb(lat, p)

    # ------------------------------------------------------------ training
    def _unstacked(self, stack: str) -> List[Dict[str, torch.Tensor]]:
        """Each layer's parameters of a stack, in the order the layers run,
        as views cut by one ``unbind``: its backward writes the stack's
        gradient once, where indexing layer by layer would write a
        stack-sized gradient for every layer. Under FSDP the caller gathers
        each layer's weights where it uses them (``_gather_layer``)."""
        depth = len(stack_depths(self.cfg)[stack])
        if not depth:
            return [dict(getattr(self, stack))]
        cols = {k: v.flatten(0, depth - 1).unbind(0)
                for k, v in getattr(self, stack).items()}
        n = len(next(iter(cols.values()))) if cols else 0
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]

    def _attend(self, q, k, v, positions):
        """Plain causal attention of whole sequences in this layout's
        grouping of q heads. The train layout's (g-major: slot s reads kv
        head s % KV) is regrouped kv-major around ``flash_prefill``, as the
        reference's ``_flash_gqa`` does; a rank of a mesh, whose q slots
        start at its offset, gives each of its slots its kv head."""
        B, S, H, hd = q.shape
        KV = k.shape[2]
        if self.layout == "serve" or KV == 1:
            return flash_prefill(q, k, v, q_positions=positions,
                                 window=self.window)
        if self.ctx.tp > 1:
            if self.kv_exact:
                first = self.ctx.comm.axis_index(self.ctx.model_axis) * H
                idx = (first + torch.arange(H, device=q.device)) % KV
                k, v = k.index_select(2, idx), v.index_select(2, idx)
            return flash_prefill(q, k, v, q_positions=positions,
                                 window=self.window)
        g = H // KV
        q = q.reshape(B, S, g, KV, hd).transpose(2, 3).reshape(B, S, H, hd)
        o = flash_prefill(q, k, v, q_positions=positions, window=self.window)
        return o.reshape(B, S, KV, g, hd).transpose(2, 3).reshape(B, S, H, hd)

    def _gqa_layer(self, x, p, positions, seq: Optional[int] = None):
        q, k, v = self._qkv(x, p, positions, seq=seq)
        x = self._out(x, self._attend(q, k, v, positions), p, seq=seq)
        return self._mlp(x, p, seq=seq)

    def _stream_cut(self, x):
        """Under ``seq_parallel_norm``: (this rank's share of x, the
        positions of the padded whole, the whole's length); else (x, its
        positions, None)."""
        S = x.shape[1]
        if not self.seq_parallel:
            return x, torch.arange(S, device=x.device)[None], None
        n = -(-S // self.ctx.tp) * self.ctx.tp
        return self._seq_cut(x), torch.arange(n, device=x.device)[None], S

    def _shared_block(self, fn, x):
        """zamba2's shared attention+MLP block ``fn(x, positions, seq) ->
        (x, kv)`` on the whole residual stream, which ``seq_parallel_norm``
        cuts for the block alone; returns (x whole again, kv)."""
        xs, pos, seq = self._stream_cut(x)
        y, kv = fn(xs, pos, seq)
        return (y if seq is None else self._seq_join(y, seq)), kv

    def _stack_layer(self, stack: str, x, p, positions, seq: Optional[int] = None):
        """One dense or MoE layer of training from its unstacked weights,
        gathered here: under ``remat="full"`` inside a checkpoint, so its
        backward gathers them again and recomputes the layer's forward
        rather than keeping its activations (the reference's
        ``_maybe_remat``)."""
        def layer(x, p):
            p = self._gather_layer(stack, p)
            if not self.mla:
                return self._gqa_layer(x, p, positions, seq)
            y, _ = mla_prefill(rmsnorm(x, p["attn_norm"], self.cfg.norm_eps), p,
                               self.cfg, positions)
            return self._mlp(x + self._psum(y), p)
        if self.ctx.remat == "full":
            return checkpoint(layer, x, p, use_reentrant=False,
                              preserve_rng_state=False)
        return layer(x, p)

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B,P+S,V) at every position of whole sequences run from
        position 0, under autograd: tokens (B,S), prefix_embeds (B,P,d) put
        before them as in ``prefill``. The reference's
        ``forward(mode=layout)``; it launches neither kernel. Under a mesh
        tokens and prefix are this rank's rows of the batch (its "data"
        shard) and the logits are theirs, whole over "model"."""
        cfg = self.cfg
        x = self._embed(tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        if cfg.family == "hybrid":
            shared = self._gather_layer("shared_attn", self._unstacked("shared_attn")[0])
            mamba = self._unstacked("mamba_stack")
            for g in range(cfg.n_layers // cfg.attn_every):
                x, _ = self._shared_block(
                    lambda xs, pos, seq: (self._gqa_layer(xs, shared, pos, seq), None), x)
                for p in mamba[g * cfg.attn_every:(g + 1) * cfg.attn_every]:
                    x = x + mamba2_forward(x, self._gather_layer("mamba_stack", p),
                                           cfg, ctx=self.ctx)[0]
        elif cfg.family == "ssm":
            (G, per), _ = stack_depths(cfg).values()
            mlstm = self._unstacked("mlstm_stack")
            for g, p_s in enumerate(self._unstacked("slstm_stack")):
                for p in mlstm[g * per:(g + 1) * per]:
                    x = mlstm_forward(x, self._gather_layer("mlstm_stack", p), cfg,
                                      ctx=self.ctx)[0]
                x = slstm_forward(x, self._gather_layer("slstm_stack", p_s), cfg,
                                  ctx=self.ctx)[0]
        else:
            x, positions, seq = self._stream_cut(x)
            for stack in stack_depths(cfg):
                for p in self._unstacked(stack):
                    x = self._stack_layer(stack, x, p, positions, seq)
            if seq is not None:
                x = self._seq_join(x, seq)
        return self._head(x)

    def _serve_layout(self):
        if self.layout != "serve":
            raise ValueError("prefill and decode_step take a serve-layout "
                             "model; this one has the train layout")

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]],
                           List[torch.Tensor]]:
        """Run whole prompts from position 0. tokens (B,S); prefix_embeds
        (B,P,d), a vlm's patch or an audio model's frame embeddings, go
        before the token embeddings in the model's dtype, so positions run
        over P+S. Returns the last position's logits (B,V); each attention
        layer's decode cache over all P+S tokens: (k, v) (B,P+S,KV,hd) for
        GQA (one per shared-block group in a hybrid), (ckv, kpe)
        (B,P+S,kv_rank) and (B,P+S,rope) for MLA; and the final recurrent
        state, one tensor for each buffer of ``state_shapes`` with the
        batch in place of the slots."""
        self._serve_layout()
        x = self._embed(tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        if self.cfg.family == "hybrid":
            x, caches, states = self._hybrid_prefill(x)
        elif self.cfg.family == "ssm":
            x, caches, states = self._xlstm_prefill(x)
        else:
            S = x.shape[1]
            x, positions, seq = self._stream_cut(x)
            caches, states = [], []
            for stack, i in self.layers:
                p = self._layer(stack, i)
                if self.mla:
                    y, cache = mla_prefill(
                        rmsnorm(x, p["attn_norm"], self.cfg.norm_eps), p,
                        self.cfg, positions)
                    x = self._mlp(x + self._psum(y), p)
                else:
                    x, (k, v) = self._gqa_prefill(x, p, positions, seq)
                    cache = (k[:, :S], v[:, :S])
                caches.append(cache)
            if seq is not None:
                x = self._seq_join(x, seq)
        return self._head(x[:, -1]), caches, states

    def _hybrid_prefill(self, x):
        """Per group: the shared block (window 0), then ``attn_every``
        Mamba2 layers, each layer's final (h, conv states) kept from this
        pass."""
        cfg = self.cfg
        S = x.shape[1]
        shared = self._layer("shared_attn")
        caches, states = [], [[] for _ in range(4)]
        for g in range(cfg.n_layers // cfg.attn_every):
            x, (k, v) = self._shared_block(
                lambda xs, pos, seq: self._gqa_prefill(xs, shared, pos, seq), x)
            caches.append((k[:, :S], v[:, :S]))
            for l in range(g * cfg.attn_every, (g + 1) * cfg.attn_every):
                y, (h, cs) = mamba2_forward(
                    x, self._layer("mamba_stack", l), cfg, ctx=self.ctx)
                x = x + y
                for acc, t in zip(states, (h, *cs)):
                    acc.append(t)
        return x, caches, [torch.stack(acc) for acc in states]

    def _xlstm_prefill(self, x):
        """Per group: ``slstm_every - 1`` mLSTM blocks, then one sLSTM
        block, each block's final state kept from this pass."""
        cfg = self.cfg
        (G, per), _ = stack_depths(cfg).values()
        mst, sst = [[] for _ in range(4)], [[] for _ in range(4)]
        for g in range(G):
            for j in range(per):
                x, st = mlstm_forward(x, self._layer("mlstm_stack", g, j), cfg,
                                      ctx=self.ctx)
                for acc, t in zip(mst, st):
                    acc.append(t)
            x, st = slstm_forward(x, self._layer("slstm_stack", g), cfg,
                                  ctx=self.ctx)
            for acc, t in zip(sst, st):
                acc.append(t)
        return x, [], [torch.stack(acc) for acc in mst + sst]

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor,
                    pools: Sequence[torch.Tensor],
                    block_tables: torch.Tensor,
                    states: Sequence[torch.Tensor] = (),
                    rows: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per sequence. tokens (B,) at ``positions`` (B,);
        ``pools`` the pools of ``pool_shapes``; block_tables
        (B,max_blocks) int32 covering each position; ``states`` the
        buffers of ``state_shapes`` and ``rows`` (B,) int64 each
        sequence's slot in them. Writes the new token's cache entries into
        the pools and the new states into the slots, in place; returns
        logits (B,V). ``valid`` (B,) bool marks the real sequences: a row
        where it is False (a pad that keeps a step's batch one shape over
        "data") writes nothing into the pools or the slots; its table and
        slot must be ones no real row of the step writes."""
        self._serve_layout()
        cfg = self.cfg
        pos = positions.long()
        x = self._embed(tokens)[:, None]
        if cfg.family == "ssm":
            return self._head(self._xlstm_decode(x, states, rows, valid)[:, 0])
        at = self._cache_slots(pos, block_tables, pools[0].shape[2], valid)
        two_d = self.two_d is not None
        if cfg.family == "hybrid":
            return self._head(self._hybrid_decode(x, pools, block_tables, at,
                                                  states, rows, valid)[:, 0],
                              two_d=two_d)
        _, pages, offs, lens, mine, s0 = at
        pool_a, pool_b = pools
        for l, (stack, i) in enumerate(self.layers):
            p = self._layer(stack, i, keep=self._decode_keep())
            if self.mla:
                h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
                a, b = mla_latents(h, p, cfg, pos[:, None])
                _put(pool_a[l], pages, offs, a[:, 0], mine)
                _put(pool_b[l], pages, offs, b[:, 0], mine)
                if self.seq_axis is None:
                    y = mla_decode_paged(h, p, cfg, pool_a[l], pool_b[l],
                                         block_tables, lens)
                else:
                    y = self._mla_split(h, p, pool_a[l], pool_b[l], block_tables,
                                        lens - s0, lens)
                x = self._mlp(x + self._psum(y), p, two_d=two_d)
            else:
                x = self._gqa_decode(x, p, pool_a[l], pool_b[l], at,
                                     block_tables)
        return self._head(x[:, 0], two_d=two_d)

    def _cache_slots(self, pos, block_tables, page, valid=None):
        """Where each sequence's new token goes: (positions, pool pages,
        offsets in them, lens = positions as int32, mine, s0). With the
        cache sequence cut over ``seq_axis`` this rank's table covers the
        n = max_blocks * page positions from s0 = its coordinate * n; the
        token's slot is taken at its position in that share, ``mine`` says
        which sequences' new token the rank holds, and lens stay global.
        ``mine`` also drops the rows ``valid`` marks as pads. Uncut and
        unpadded, ``mine`` is None and s0 0."""
        lens = pos.to(torch.int32)
        if self.seq_axis is None:
            pages = block_tables.long().gather(1, (pos // page)[:, None])[:, 0]
            return pos, pages, pos % page, lens, valid, 0
        n = block_tables.shape[1] * page
        s0 = self.ctx.comm.axis_index(self.seq_axis) * n
        local = pos - s0
        mine = (local >= 0) & (local < n)
        if valid is not None:
            mine = mine & valid
        local = local.clamp(0, n - 1)
        pages = block_tables.long().gather(1, (local // page)[:, None])[:, 0]
        return pos, pages, local % page, lens, mine, s0

    def _hybrid_decode(self, x, pools, block_tables, at, states, rows, valid=None):
        """Per group g: the shared block on pool g through K2, then its
        Mamba2 layers on the batch's rows of the state buffers (a pad row's
        slot keeps its state)."""
        cfg = self.cfg
        shared = self._layer("shared_attn", keep=self._decode_keep())
        pool_k, pool_v = pools
        for g in range(cfg.n_layers // cfg.attn_every):
            x = self._gqa_decode(x, shared, pool_k[g], pool_v[g], at,
                                 block_tables)
            for l in range(g * cfg.attn_every, (g + 1) * cfg.attn_every):
                h, *cs = old = [buf[l].index_select(0, rows) for buf in states]
                y, new = mamba2_decode(x, self._layer("mamba_stack", l), cfg,
                                       (h, tuple(cs)), ctx=self.ctx)
                x = x + y
                _put_rows(states, l, rows, (new[0], *new[1]), old, valid)
        return x

    def _xlstm_decode(self, x, states, rows, valid=None):
        cfg = self.cfg
        (G, per), _ = stack_depths(cfg).values()
        mst, sst = states[:4], states[4:]
        for g in range(G):
            for j in range(per):
                l = g * per + j
                st = tuple(buf[l].index_select(0, rows) for buf in mst)
                x, new = mlstm_decode(x, self._layer("mlstm_stack", g, j), cfg, st,
                                      ctx=self.ctx)
                _put_rows(mst, l, rows, new, st, valid)
            st = tuple(buf[g].index_select(0, rows) for buf in sst)
            x, new = slstm_decode(x, self._layer("slstm_stack", g), cfg, st,
                                  ctx=self.ctx)
            _put_rows(sst, g, rows, new, st, valid)
        return x


def _put(pool: torch.Tensor, pages, offs, new: torch.Tensor, keep):
    """pool[pages, offs] = new cast to the pool's dtype
    (``to_cache_dtype``), but the old entry on each row ``keep`` (None:
    every row) drops."""
    new = writable(to_cache_dtype(new, pool.dtype))
    pool = writable(pool)
    if keep is not None:
        new = torch.where(keep.view(-1, *(1,) * (new.ndim - 1)), new, pool[pages, offs])
    pool[pages, offs] = new


def _put_rows(bufs, layer: int, rows, new, old, valid):
    """Each state buffer's ``rows`` of ``layer`` set to ``new``, but the rows
    ``valid`` marks as pads keep ``old`` (None: every row is real)."""
    for buf, t, o in zip(bufs, new, old):
        if valid is not None:
            t = torch.where(valid.view(-1, *(1,) * (t.ndim - 1)), t, o)
        buf[layer].index_copy_(0, rows, t)


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's training loss: ``softmax_xent`` of
    ``model(batch["tokens"], batch.get("prefix_embeds"))`` against
    ``batch["labels"]`` (B,S), under ``batch.get("mask")``. With a prefix
    the P prefix positions take label 0 and are masked out.

    Under a mesh the batch is this rank's rows and the value is the global
    masked mean over every "data" rank's rows. Its gradient on each rank is
    the rank's share: its rows' sum over the global count, over the
    "model" size, since every "model" rank computes the same term and the
    collectives' transposes add the ranks' shares
    (``repro_torch.parallel.collectives``). Without a mesh the sums over
    ranks are over one and the value is ``softmax_xent``'s."""
    logits = model(batch["tokens"], batch.get("prefix_embeds"))
    labels = batch["labels"]
    pad = logits.shape[1] - labels.shape[1]
    if pad:
        B, S = labels.shape
        labels = F.pad(labels, (pad, 0))
        mask = torch.cat([torch.zeros((B, pad), device=labels.device),
                          torch.ones((B, S), device=labels.device)], dim=1)
    else:
        mask = batch.get("mask")
    ctx = model.ctx
    nll = token_xent(logits, labels)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    with torch.no_grad():
        count = mask.sum()
        for axis in ctx.batch_axes:
            count = ctx.comm.psum(count, axis)
    share = (nll * mask).sum() / count.clamp_min(1.0)
    with torch.no_grad():
        value = share.clone()
        for axis in ctx.batch_axes:
            value = ctx.comm.psum(value, axis)
    share = share / ctx.tp
    return share + (value - share.detach())
