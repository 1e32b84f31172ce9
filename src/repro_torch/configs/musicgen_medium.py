"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA: kv=24) d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB per the brief: input_specs() supplies
precomputed frame embeddings (delay-pattern codebook interleave is upstream
of the backbone). Full MHA -> the highest kv-head count in the pool, which
stresses the KV-capacity axis per parameter.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "musicgen-medium"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    attention="full",
    rope_theta=10000.0,
    frontend_prefix_len=0,
    notes="audio token decoder; MHA (kv=24) maximizes KV bytes/token/layer ratio",
)
