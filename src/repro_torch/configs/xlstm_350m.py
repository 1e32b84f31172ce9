"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 vocab=50304.
Attention-free: matrix-memory (mLSTM) and scalar-memory (sLSTM) recurrence.
d_ff=0 -> blocks carry their own up/down projections (no separate FFN).
Every 8th block is sLSTM (the 7:1 xLSTM ratio); the rest are mLSTM.
Constant decode state -> long_500k runs; paged-KV machinery is inapplicable
(see DESIGN.md §4) and the engine uses fixed-size state slots instead.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "xlstm-350m"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    attention="none",
    slstm_every=8,
    notes="attention-free xLSTM; O(1) state, no KV cache",
)
