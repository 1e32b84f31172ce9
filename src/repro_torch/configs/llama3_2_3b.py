"""llama3.2-3b — small dense llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
Paper regime: small-dense / DP-dominant (§IV, Obs 4-5).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama3.2-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    attention="full",
    rope_theta=500000.0,
    tie_embeddings=True,
    notes="small llama3; DP-dominant regime in the paper's taxonomy",
)
