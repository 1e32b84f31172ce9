"""Dense GQA decoder of the serving path, as the dense family of
``repro.models.transformer`` in its serve layout at tp=1.

Parameters keep the JAX package's names and shapes, so weights move between
the two unchanged (``repro_torch.models.bridge``): stacked layers under
``dense_stack``, ``wq (L,d,H,hd)``, ``wk``/``wv (L,d,KV,hd)``,
``wo (L,H,hd,d)``, kv-major heads (q head h reads kv head h // (H/KV)), and
a tied ``embed``. Prefill attention is the CUDA flash kernel and decode
attention the CUDA paged kernel; the projections and the MLP are
``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models.common import rmsnorm, rope

# name -> (shape, init, fan_in); init is "normal" (std 1/sqrt(fan_in)) or
# "ones", as ``build_param_specs`` gives them
Spec = Tuple[Tuple[int, ...], str, int]


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Flat names of the serve parameters, in initialisation order."""
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "embed": ((V, d), "normal", d),
        "final_norm": ((d,), "ones", 1),
        "dense_stack.attn_norm": ((L, d), "ones", 1),
        "dense_stack.wq": ((L, d, H, hd), "normal", d),
        "dense_stack.wk": ((L, d, KV, hd), "normal", d),
        "dense_stack.wv": ((L, d, KV, hd), "normal", d),
        "dense_stack.wo": ((L, H, hd, d), "normal", H * hd),
        "dense_stack.mlp_norm": ((L, d), "ones", 1),
        "dense_stack.w_gate": ((L, d, f), "normal", d),
        "dense_stack.w_up": ((L, d, f), "normal", d),
        "dense_stack.w_down": ((L, f, d), "normal", f),
    }


def check_supported(cfg: ModelConfig):
    if (cfg.family != "dense" or cfg.attention != "full" or cfg.qk_norm
            or not cfg.tie_embeddings or cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense full-attention decoders with "
            "tied embeddings and no qk-norm only")


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
        stack = {}
        for name, (shape, _, _) in self.specs.items():
            p = nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                             requires_grad=False)
            if name.startswith("dense_stack."):
                stack[name.split(".", 1)[1]] = p
            else:
                setattr(self, name, p)
        self.dense_stack = nn.ParameterDict(stack)
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
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = dict(self.named_parameters())
        for name, (shape, init, fan_in) in self.specs.items():
            if init == "ones":
                params[name].fill_(1.0)
                continue
            # one fp32 draw alive at a time (a stacked weight can take GBs)
            params[name].copy_(torch.randn(
                shape, generator=gen, device=self.device,
                dtype=torch.float32).div_(math.sqrt(fan_in)))

    # ------------------------------------------------------------ layers
    def _layer(self, l: int) -> Dict[str, torch.Tensor]:
        return {k: v[l] for k, v in self.dense_stack.items()}

    def _qkv(self, x, p, positions):
        """x (B,S,d); positions (B,S) or (1,S). q (B,S,H,hd), k/v (B,S,KV,hd)."""
        cfg = self.cfg
        B, S, d = x.shape
        hd = cfg.resolved_head_dim
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q = (h @ p["wq"].reshape(d, -1)).view(B, S, cfg.n_heads, hd)
        k = (h @ p["wk"].reshape(d, -1)).view(B, S, cfg.n_kv_heads, hd)
        v = (h @ p["wv"].reshape(d, -1)).view(B, S, cfg.n_kv_heads, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _out(self, x, o, p):
        B, S = o.shape[:2]
        return x + o.reshape(B, S, -1) @ p["wo"].reshape(-1, self.cfg.d_model)

    def _mlp(self, x, p):
        h = rmsnorm(x, p["mlp_norm"], self.cfg.norm_eps)
        return x + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]

    def _head(self, x):
        """Final norm and the tied head: x (B,d) -> logits (B,V)."""
        return rmsnorm(x, self.final_norm, self.cfg.norm_eps) @ self.embed.t()

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        """Run whole prompts from position 0. tokens (B,S). Returns the last
        position's logits (B,V) and each layer's k and v (B,S,KV,hd)."""
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        ks, vs = [], []
        for l in range(self.cfg.n_layers):
            p = self._layer(l)
            q, k, v = self._qkv(x, p, positions)
            x = self._mlp(self._out(x, flash_attention(q, k, v), p), p)
            ks.append(k)
            vs.append(v)
        return self._head(x[:, -1]), ks, vs

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor,
                    k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
        """One token per sequence. tokens (B,) at ``positions`` (B,); pools
        (L,P,page,KV,hd); block_tables (B,max_blocks) int32 covering each
        position. Writes the new k/v into the pools in place and returns
        logits (B,V)."""
        cfg = self.cfg
        B = tokens.shape[0]
        page = k_pool.shape[2]
        pos = positions.long()
        pages = block_tables.long().gather(1, (pos // page)[:, None])[:, 0]
        slots = pos % page
        lens = pos.to(torch.int32)
        g = cfg.n_heads // cfg.n_kv_heads
        x = self.embed[tokens][:, None]
        for l in range(cfg.n_layers):
            p = self._layer(l)
            q, k, v = self._qkv(x, p, pos[:, None])
            k_pool[l, pages, slots] = k[:, 0]
            v_pool[l, pages, slots] = v[:, 0]
            o = paged_attention(q.view(B, cfg.n_kv_heads, g, -1), k_pool[l],
                                v_pool[l], block_tables, lens)
            x = self._mlp(self._out(x, o.view(B, 1, cfg.n_heads, -1), p), p)
        return self._head(x[:, 0])
