"""qwen3-14b — qk_norm + GQA [hf:Qwen/Qwen3-8B; hf].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
Paper regime: the 14B DP-dominant point of Fig 7/8 (Obs 5).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-14b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    attention="full",
    qk_norm=True,
    rope_theta=1000000.0,
    notes="qk_norm GQA dense",
)
