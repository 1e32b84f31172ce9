"""Model configuration schema.

One ``ModelConfig`` describes everything the substrate needs to build an
architecture: the transformer geometry, the attention flavour (full / sliding
window / MLA), MoE routing, and SSM/xLSTM block layout for the hybrid and
attention-free families.

All assigned architectures (and the paper's own model family) are expressed as
instances of this dataclass — see the sibling ``<arch>.py`` modules and
``registry.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-Head Latent Attention (DeepSeek-R1 family, §II-B of the paper)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512          # latent the KV cache stores (decouples cache from heads)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared_experts: int = 0        # DeepSeek/Kimi-style always-on shared expert(s)
    first_dense_layers: int = 0      # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block geometry."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128                 # chunk length for the chunked-scan train path


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    attention: str = "full"          # full | swa | mla | none
    swa_window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared* (weight-tied) attention+MLP block inserted
    # every `attn_every` SSM layers.  attn_every == 0 -> no attention blocks.
    attn_every: int = 0
    # xlstm: every `slstm_every`-th block is an sLSTM (scalar-memory) block,
    # the rest are mLSTM (matrix-memory).  0 -> all mLSTM.
    slstm_every: int = 0
    # modality frontends (vlm/audio) are stubs: input_specs() hands the
    # backbone precomputed patch/frame embeddings of this length.
    frontend_prefix_len: int = 0
    notes: str = ""

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def is_subquadratic(self) -> bool:
        """True if long-context decode is admissible (brief: run long_500k)."""
        return self.family in ("ssm", "hybrid") or self.attention == "swa"

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-token KV-cache footprint across all layers (paper §II-B)."""
        if self.attention == "mla":
            assert self.mla is not None
            per_layer = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
            n_attn = self.n_layers
        elif self.attention == "none":
            return 0  # constant state instead — see state_bytes_per_seq
        else:
            per_layer = 2 * self.n_kv_heads * self.resolved_head_dim
            n_attn = self.n_attention_layers
        return per_layer * n_attn * dtype_bytes

    @property
    def n_attention_layers(self) -> int:
        if self.family == "hybrid" and self.attn_every:
            return self.n_layers // self.attn_every
        if self.attention == "none":
            return 0
        return self.n_layers

    @property
    def n_ssm_layers(self) -> int:
        if self.family == "hybrid" and self.attn_every:
            return self.n_layers
        if self.family == "ssm":
            return 0  # xlstm uses its own blocks, not mamba
        return 0

    def state_bytes_per_seq(self, dtype_bytes: int = 4) -> int:
        """Constant per-sequence recurrent state (SSM / xLSTM / conv)."""
        total = 0
        if self.ssm is not None:
            d_inner = self.ssm.expand * self.d_model
            n_heads = d_inner // self.ssm.head_dim
            per_layer = n_heads * self.ssm.head_dim * self.ssm.d_state \
                + d_inner * (self.ssm.conv_width - 1)
            total += per_layer * self.n_layers * dtype_bytes
        if self.family == "ssm":  # xlstm matrix memory
            hd = self.resolved_head_dim
            per_layer = self.n_heads * hd * hd + 2 * self.n_heads * hd + 4 * self.n_heads
            total += per_layer * self.n_layers * dtype_bytes
        return total

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6·N·D)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb
        hd = self.resolved_head_dim
        for i in range(self.n_layers):
            n += self._layer_params(i, hd)
        if self.family == "hybrid" and self.attn_every:
            # one weight-tied shared attention+MLP block (counted once)
            n += self._attn_params(hd) + 3 * d * self.d_ff + 2 * d
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE activates top_k + shared)."""
        if self.moe is None or self.moe.n_experts == 0:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        moe_layers = self.n_layers - m.first_dense_layers
        inactive = moe_layers * (m.n_experts - m.top_k) * 3 * d * m.d_ff_expert
        return total - inactive

    # -- internals -------------------------------------------------------------
    def _attn_params(self, hd: int) -> int:
        d = self.d_model
        if self.attention == "mla":
            assert self.mla is not None
            ml = self.mla
            qk_head = ml.qk_nope_head_dim + ml.qk_rope_head_dim
            return (d * ml.q_lora_rank + ml.q_lora_rank * self.n_heads * qk_head
                    + d * (ml.kv_lora_rank + ml.qk_rope_head_dim)
                    + ml.kv_lora_rank * self.n_heads * (ml.qk_nope_head_dim + ml.v_head_dim)
                    + self.n_heads * ml.v_head_dim * d)
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _layer_params(self, i: int, hd: int) -> int:
        d = self.d_model
        if self.family == "ssm":      # xlstm block
            if self.slstm_every and (i + 1) % self.slstm_every == 0:
                return 4 * d * d + 4 * self.n_heads * hd * hd + 2 * d * 4 * d  # approx
            return 2 * d * 2 * d + 2 * d * d + 3 * d * d                        # mLSTM approx
        if self.family == "hybrid":   # mamba2 layer (shared attn counted separately)
            assert self.ssm is not None
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            ds = self.ssm.d_state
            return (d * (2 * di + 2 * ds + nh)            # in_proj (x,z,B,C,dt)
                    + (di + 2 * ds) * self.ssm.conv_width  # short conv
                    + 3 * nh + di                          # A_log, D, dt_bias, norm
                    + di * d)                              # out_proj
        n = 2 * d  # norms
        n += self._attn_params(hd)
        if self.moe is not None and self.moe.n_experts and i >= self.moe.first_dense_layers:
            m = self.moe
            n += d * m.n_experts  # router
            n += (m.n_experts + m.n_shared_experts) * 3 * d * m.d_ff_expert
        else:
            n += 3 * d * self.d_ff
        return n


def reduced(cfg: ModelConfig, *, layers: int = 0) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests."""
    n_layers = layers or (4 if (cfg.attn_every or cfg.slstm_every) else 2)
    if cfg.attn_every:
        n_layers = max(n_layers, 2 * cfg.attn_every)  # keep ≥2 shared-attn insertions
        n_layers = 2 * cfg.attn_every
    if cfg.slstm_every:
        n_layers = 2 * cfg.slstm_every
    kv = min(cfg.n_kv_heads, 2)
    heads = max(4, kv * min(cfg.q_per_kv, 2))
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        frontend_prefix_len=min(cfg.frontend_prefix_len, 4),
        swa_window=16,
    )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.moe is not None and cfg.moe.n_experts:
        # capacity_factor 8 -> no token drops at smoke scale, so the batched
        # and incremental paths agree exactly (drop semantics get their own
        # unit test in tests/test_moe.py)
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            capacity_factor=8.0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, expand=2, head_dim=16, conv_width=4, chunk=8)
    return dataclasses.replace(cfg, **kw)
