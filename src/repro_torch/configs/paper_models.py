"""The paper's own evaluated model family (§III-C).

DeepSeek-R1-Distill (Llama-8B, Qwen-14B, Qwen-32B, Llama-70B) — dense GQA,
plus DeepSeek-R1-671B — MoE with Multi-Head Latent Attention (MLA).
These configs drive the paper-reproduction benchmarks (Figs 2-15) and the
parallelism planner regression tests; llama3-405b (also a paper subject) is an
assigned arch and lives in its own module.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

DS_DISTILL_8B = ModelConfig(
    name="ds-distill-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, attention="full", rope_theta=500000.0,
    notes="DeepSeek-R1-Distill-Llama-8B (paper's small-model subject)")

DS_DISTILL_14B = ModelConfig(
    name="ds-distill-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064, attention="full", rope_theta=1000000.0,
    notes="DeepSeek-R1-Distill-Qwen-14B")

DS_DISTILL_32B = ModelConfig(
    name="ds-distill-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab=152064, attention="full", rope_theta=1000000.0,
    notes="DeepSeek-R1-Distill-Qwen-32B (paper: 262 KB/token, the DP->TP crossover)")

DS_DISTILL_70B = ModelConfig(
    name="ds-distill-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, attention="full", rope_theta=500000.0,
    notes="DeepSeek-R1-Distill-Llama-70B (paper: 328 KB/token)")

DEEPSEEK_R1_671B = ModelConfig(
    name="deepseek-r1-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280, attention="mla", rope_theta=10000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=3,
                  capacity_factor=1.25),
    notes="paper's sparse frontier subject; MLA compresses KV to 576/token/layer")

PAPER_MODELS = {m.name: m for m in (
    DS_DISTILL_8B, DS_DISTILL_14B, DS_DISTILL_32B, DS_DISTILL_70B,
    DEEPSEEK_R1_671B)}
