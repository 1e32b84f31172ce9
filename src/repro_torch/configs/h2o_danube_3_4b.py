"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
SWA bounds the KV working set -> long_500k decode runs for this arch
(sub-quadratic: per-step attention touches only the window).
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "h2o-danube-3-4b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    attention="swa",
    swa_window=4096,
    rope_theta=10000.0,
    notes="sliding-window attention caps per-request KV (capacity trap shifts right)",
)
