"""Decoder of the serving path: the dense and MoE families of
``repro.models.transformer`` in their serve layout at tp=1.

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
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.attention import (mla_decode_paged, mla_latents,
                                          mla_prefill)
from repro_torch.models.common import rmsnorm, rope
from repro_torch.models.moe import moe_ffn

# name -> (shape, init, fan_in); init is "normal" (std 1/sqrt(fan_in)) or
# "ones", as ``build_param_specs`` gives them
Spec = Tuple[Tuple[int, ...], str, int]
# the most elements one fp32 draw of ``init_weights`` holds (256 MiB)
INIT_CHUNK = 1 << 26


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


def stack_depths(cfg: ModelConfig) -> Dict[str, int]:
    """Layers in each stack, in the order the layers run."""
    if cfg.moe is not None and cfg.moe.n_experts:
        nd = cfg.moe.first_dense_layers
        return {"dense_stack": nd, "moe_stack": cfg.n_layers - nd}
    return {"dense_stack": cfg.n_layers, "moe_stack": 0}


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Flat names of the serve parameters, in initialisation order."""
    d, V = cfg.d_model, cfg.vocab
    specs: Dict[str, Spec] = {"embed": ((V, d), "normal", d),
                              "final_norm": ((d,), "ones", 1)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ((d, V), "normal", d)
    layer = {"dense_stack": {**_attn_specs(cfg), **_mlp_specs(cfg)},
             "moe_stack": ({**_attn_specs(cfg), **_moe_specs(cfg)}
                           if cfg.moe is not None else {})}
    for stack, n in stack_depths(cfg).items():
        if n:
            for name, (shape, init, fan_in) in layer[stack].items():
                specs[f"{stack}.{name}"] = ((n, *shape), init, fan_in)
    return specs


def check_supported(cfg: ModelConfig):
    if (cfg.family not in ("dense", "moe")
            or cfg.attention not in ("full", "swa", "mla")):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense and MoE decoders with full "
            "or sliding-window (GQA) or latent (MLA) attention only")


class Transformer(nn.Module):
    """``seed`` fills the weights on the device from a ``torch.Generator``;
    ``seed=None`` leaves them uninitialised for a caller that loads them."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, seed: Optional[int] = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.specs = param_specs(cfg)
        self.mla = cfg.attention == "mla"
        self.window = cfg.swa_window if cfg.attention == "swa" else 0
        stacks = {"dense_stack": {}, "moe_stack": {}}
        for name, (shape, _, _) in self.specs.items():
            p = nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                             requires_grad=False)
            stack, _, leaf = name.rpartition(".")
            if stack:
                stacks[stack][leaf] = p
            else:
                setattr(self, name, p)
        self.dense_stack = nn.ParameterDict(stacks["dense_stack"])
        self.moe_stack = nn.ParameterDict(stacks["moe_stack"])
        # (stack, index in it) of each layer, in the order the layers run
        self.layers = [(stack, i) for stack, n in stack_depths(cfg).items()
                       for i in range(n)]
        if seed is not None:
            self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @torch.no_grad()
    def init_weights(self, seed: int):
        """Normal weights with std 1/sqrt(fan_in), norms ones. Each weight
        is drawn in fp32 in consecutive pieces of its memory of at most
        ``INIT_CHUNK`` elements (256 MiB), so the draws of a full-width MoE
        stack fit beside its weights on the card (at 5 layers, R1's
        ``we_gate`` alone is 7.5 G elements)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = dict(self.named_parameters())
        for name, (_, init, fan_in) in self.specs.items():
            flat = params[name].view(-1)
            if init == "ones":
                flat.fill_(1.0)
                continue
            for start in range(0, flat.numel(), INIT_CHUNK):
                piece = flat[start:start + INIT_CHUNK]
                piece.copy_(torch.randn(
                    piece.numel(), generator=gen, device=self.device,
                    dtype=torch.float32).div_(math.sqrt(fan_in)))

    def pool_shapes(self, n_pages: int, page: int) -> List[Tuple[int, ...]]:
        """Shapes of the two paged decode-cache pools: k and v
        (L,P,page,KV,hd) for GQA; ckv (L,P,page,kv_rank) and kpe
        (L,P,page,rope) for MLA."""
        cfg = self.cfg
        L = cfg.n_layers
        if self.mla:
            return [(L, n_pages, page, cfg.mla.kv_lora_rank),
                    (L, n_pages, page, cfg.mla.qk_rope_head_dim)]
        shape = (L, n_pages, page, cfg.n_kv_heads, cfg.resolved_head_dim)
        return [shape, shape]

    # ------------------------------------------------------------ layers
    def _layer(self, stack: str, i: int) -> Dict[str, torch.Tensor]:
        return {k: v[i] for k, v in getattr(self, stack).items()}

    def _qkv(self, x, p, positions):
        """x (B,S,d); positions (B,S) or (1,S). q (B,S,H,hd), k/v (B,S,KV,hd)."""
        cfg = self.cfg
        B, S, d = x.shape
        hd = cfg.resolved_head_dim
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q = (h @ p["wq"].reshape(d, -1)).view(B, S, cfg.n_heads, hd)
        k = (h @ p["wk"].reshape(d, -1)).view(B, S, cfg.n_kv_heads, hd)
        v = (h @ p["wv"].reshape(d, -1)).view(B, S, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["qn"], cfg.norm_eps)
            k = rmsnorm(k, p["kn"], cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _out(self, x, o, p):
        B, S = o.shape[:2]
        return x + o.reshape(B, S, -1) @ p["wo"].reshape(-1, self.cfg.d_model)

    def _mlp(self, x, p):
        h = rmsnorm(x, p["mlp_norm"], self.cfg.norm_eps)
        if "router" in p:
            return x + moe_ffn(h, p, self.cfg)
        return x + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]

    def _head(self, x):
        """Final norm and the head: x (B,d) -> logits (B,V)."""
        h = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return h @ (self.embed.t() if self.cfg.tie_embeddings else self.lm_head)

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Run whole prompts from position 0. tokens (B,S). Returns the last
        position's logits (B,V) and each layer's decode cache: (k, v)
        (B,S,KV,hd) for GQA, (ckv, kpe) (B,S,kv_rank) and (B,S,rope) for
        MLA."""
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        caches = []
        for stack, i in self.layers:
            p = self._layer(stack, i)
            if self.mla:
                y, cache = mla_prefill(
                    rmsnorm(x, p["attn_norm"], self.cfg.norm_eps), p,
                    self.cfg, positions)
                x = x + y
            else:
                q, k, v = self._qkv(x, p, positions)
                x = self._out(x, flash_attention(q, k, v, window=self.window),
                              p)
                cache = (k, v)
            x = self._mlp(x, p)
            caches.append(cache)
        return self._head(x[:, -1]), caches

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor,
                    pools: Sequence[torch.Tensor],
                    block_tables: torch.Tensor) -> torch.Tensor:
        """One token per sequence. tokens (B,) at ``positions`` (B,);
        ``pools`` the two pools of ``pool_shapes``; block_tables
        (B,max_blocks) int32 covering each position. Writes the new token's
        cache entries into the pools in place, then attends; returns logits
        (B,V)."""
        cfg = self.cfg
        B = tokens.shape[0]
        pool_a, pool_b = pools
        page = pool_a.shape[2]
        pos = positions.long()
        pages = block_tables.long().gather(1, (pos // page)[:, None])[:, 0]
        slots = pos % page
        lens = pos.to(torch.int32)
        x = self.embed[tokens][:, None]
        for l, (stack, i) in enumerate(self.layers):
            p = self._layer(stack, i)
            if self.mla:
                h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
                a, b = mla_latents(h, p, cfg, pos[:, None])
                pool_a[l, pages, slots] = a[:, 0]
                pool_b[l, pages, slots] = b[:, 0]
                x = x + mla_decode_paged(h, p, cfg, pool_a[l], pool_b[l],
                                         block_tables, lens)
            else:
                q, a, b = self._qkv(x, p, pos[:, None])
                pool_a[l, pages, slots] = a[:, 0]
                pool_b[l, pages, slots] = b[:, 0]
                g = cfg.n_heads // cfg.n_kv_heads
                o = paged_attention(q.view(B, cfg.n_kv_heads, g, -1),
                                    pool_a[l], pool_b[l], block_tables, lens,
                                    window=self.window)
                x = self._out(x, o.view(B, 1, cfg.n_heads, -1), p)
            x = self._mlp(x, p)
        return self._head(x[:, 0])
