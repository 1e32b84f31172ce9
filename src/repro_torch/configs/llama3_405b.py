"""llama3-405b — dense frontier, GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
This is the paper's dense-frontier subject (Fig 10/14: TP8 986s vs PP8 7537s;
KV = 1.05 MB/token in FP16 -> the "Reasoning Cliff" arch).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama3-405b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    attention="full",
    rope_theta=500000.0,
    notes="paper's dense frontier model; 1.05MB/token KV, interconnect+HBM bound",
)
