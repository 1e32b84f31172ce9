"""internvl2-76b — VLM: InternViT + InternLM2 backbone [arXiv:2404.16821; unverified].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision frontend (InternViT) is a STUB per the brief: input_specs() supplies
precomputed patch embeddings of length ``frontend_prefix_len`` which the
backbone consumes as a prefix before the text tokens.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internvl2-76b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    attention="full",
    rope_theta=1000000.0,
    frontend_prefix_len=256,   # one 448x448 tile -> 256 patch embeddings
    notes="LLM backbone only; ViT frontend stubbed as precomputed patch embeddings",
)
