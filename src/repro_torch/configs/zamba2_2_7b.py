"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (MHA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Hybrid: 54 Mamba2 layers with ONE weight-tied (shared) attention+MLP block
invoked every 6 layers (9 invocations, 9 distinct KV caches, tied weights).
O(1) SSM state + small periodic KV -> the capacity trap largely vanishes;
long_500k decode runs for this arch.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    attention="full",       # flavour of the shared attention block
    rope_theta=10000.0,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4, chunk=128),
    attn_every=6,
    notes="Mamba2 + weight-tied shared attention block every 6 layers",
)
