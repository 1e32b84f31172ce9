"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064, MoE 16e top-2.
Paper regime: the MoE divergence (Obs 6) at mid scale - sync-sensitive,
favors lower TP degree + expert parallelism.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,               # dense-equivalent ff (unused when every layer is MoE)
    vocab=32064,
    attention="full",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400,
                  n_shared_experts=0, first_dense_layers=0,
                  capacity_factor=1.25),
    notes="every layer MoE; EP maps 1 expert/device on a 16-way model axis",
)
