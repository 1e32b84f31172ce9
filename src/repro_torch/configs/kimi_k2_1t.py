"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384e top-8.
Frontier-sparse analogue of the paper's DeepSeek-R1-671B (Obs 6): low active
parameter count -> compute-to-communication ratio collapses under high-degree
TP; hybrid EP+PP+low-TP preferred.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "kimi-k2-1t-a32b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,              # dense d_ff for the first dense layer
    vocab=163840,
    attention="full",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=1,
                  capacity_factor=1.25),
    notes="384-expert top-8; 24 experts per device on 16-way EP; ~32B active",
)
