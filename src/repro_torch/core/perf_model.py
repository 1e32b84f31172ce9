"""Analytical step-latency model for (model x phase x parallelism x hardware).

This is the quantitative core of the paper's decision framework (§IV-§VI):
prefill is compute-bound, decode is HBM-bandwidth + capacity bound, TP pays
per-layer all-reduce bandwidth *and* latency (the alpha term that throttles
sparse models, Obs 6), PP pays bubbles that KV capacity may prevent filling
(the 405B pathology), and DP pays nothing but replicates weights (the
capacity trap, Obs 3/4).

The same model drives the discrete-event simulator (benchmarks, paper-figure
reproduction on H200 constants) and the deployment planner (v5e constants);
the port adds H100 constants, the card it runs on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    flops: float              # dense peak FLOP/s per device (bf16/fp16)
    hbm_bw: float             # B/s per device
    hbm_cap: float            # bytes per device
    link_bw: float            # intra-node interconnect B/s per device
    link_alpha: float         # per-collective latency (s)
    inter_bw: float = 0.0     # cross-node B/s per device (PP transport)
    mxu_eff: float = 0.55     # achievable fraction of peak on GEMMs
    bw_eff: float = 0.75      # achievable fraction of HBM bandwidth


H200 = Hardware(name="h200-sxm", flops=989e12, hbm_bw=4.8e12, hbm_cap=141e9,
                link_bw=450e9, link_alpha=4e-6, inter_bw=60e9)
V5E = Hardware(name="tpu-v5e", flops=197e12, hbm_bw=819e9, hbm_cap=16e9,
               link_bw=50e9, link_alpha=1e-6, inter_bw=50e9)
# the port's card, at the published dense bf16 and HBM3 peaks of one H100
# SXM; its NVLink and network are H200's generation, so the link terms are
# H200's
H100 = Hardware(name="h100-sxm", flops=989e12, hbm_bw=3.35e12, hbm_cap=80e9,
                link_bw=450e9, link_alpha=4e-6, inter_bw=60e9)

# per-microbatch-pass pipeline overhead (stage hand-off, host-driven step
# launch; vLLM PP's known decode tax). Calibrated on the paper's 14B
# PP2+TP4 = 3.5x-DP8 and 405B PP8 = 7.6x-TP8 points.
PP_PASS_OVERHEAD = {"h200-sxm": 5e-3, "tpu-v5e": 2e-3}


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1               # expert parallel degree (folded into tp domain)

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.pp

    def label(self) -> str:
        parts = [f"DP={self.dp}"] if self.dp > 1 else []
        if self.tp > 1:
            parts.append(f"TP={self.tp}")
        if self.pp > 1:
            parts.append(f"PP={self.pp}")
        return "+".join(parts) or "DP=1"


def weight_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return cfg.param_count() * dtype_bytes


def kv_bytes(cfg: ModelConfig, tokens: int, dtype_bytes: int = 2,
             n_seqs: int = 1) -> float:
    """Cache footprint of `n_seqs` sequences totalling `tokens` of context:
    per-token KV across all attention layers plus the constant per-sequence
    recurrent state (SSM/xLSTM/conv)."""
    return cfg.kv_bytes_per_token(dtype_bytes) * tokens \
        + cfg.state_bytes_per_seq(dtype_bytes) * n_seqs


def kv_capacity_tokens(cfg: ModelConfig, plan: ParallelismPlan, hw: Hardware,
                       dtype_bytes: int = 2, overhead: float = 0.10,
                       cache_dtype_bytes: int = 2) -> int:
    """Tokens of KV that fit per replica after weights + runtime overhead.
    TP/PP shard both weights and cache; DP replicates weights (Obs 3)."""
    shard = plan.tp * plan.pp
    w = weight_bytes(cfg, dtype_bytes) / shard
    free = hw.hbm_cap * (1 - overhead) - w
    per_tok = kv_bytes(cfg, 1, cache_dtype_bytes, n_seqs=0) / shard
    if per_tok <= 0:                          # attention-free: state-bound
        return 10 ** 12
    return max(int(free / per_tok), 0)


def _tp_eff(tp: int) -> float:
    """Small-GEMM efficiency decay under TP sharding (per-GPU matmul shrinks;
    calibrated so DP beats TP for <=14B as in paper Fig 8/9)."""
    return 1.0 - 0.10 * math.log2(max(tp, 1))


def _collective_time(bytes_payload: float, n: int, hw: Hardware,
                     kind: str = "all-reduce") -> float:
    """alpha-beta ring model: latency scales with ring steps — the sync cost
    that penalises high-degree TP for low-arithmetic-intensity (MoE) models
    (paper Obs 6)."""
    if n <= 1:
        return 0.0
    factor = {"all-reduce": 2 * (n - 1) / n, "all-gather": (n - 1) / n,
              "all-to-all": (n - 1) / n}[kind]
    steps = {"all-reduce": 2 * (n - 1), "all-gather": n - 1,
             "all-to-all": n - 1}[kind]
    return bytes_payload * factor / hw.link_bw + steps * hw.link_alpha


def prefill_step_time(cfg: ModelConfig, tokens: int, plan: ParallelismPlan,
                      hw: Hardware, dtype_bytes: int = 2) -> Dict[str, float]:
    """One chunked-prefill iteration over `tokens` batched tokens."""
    n_act = cfg.active_param_count()
    t_compute = 2 * n_act * tokens / (plan.tp * plan.pp * hw.flops
                                      * hw.mxu_eff * _tp_eff(plan.tp))
    t_mem = weight_bytes(cfg, dtype_bytes) / (plan.tp * plan.pp) \
        / (hw.hbm_bw * hw.bw_eff)
    # TP: 2 all-reduces of activations per layer
    ar_bytes = tokens * cfg.d_model * dtype_bytes
    t_tp = 2 * cfg.n_layers * _collective_time(ar_bytes, plan.tp, hw) \
        / plan.pp
    if cfg.moe and cfg.moe.n_experts:
        a2a = tokens * cfg.d_model * dtype_bytes * cfg.moe.top_k
        t_tp += 2 * cfg.n_layers * _collective_time(a2a, max(plan.ep, plan.tp),
                                                    hw, "all-to-all") / plan.pp
    return {"compute": t_compute, "memory": t_mem, "comm": t_tp,
            "total": max(t_compute, t_mem) + t_tp}


MOE_SYNC_ALPHA = 160e-6   # calibrated to the paper's R1 TP8 sync pathology
                          # (§V-C Obs 6): per-collective host+launch+a2a
                          # latency for non-graphed MoE layers, scaling
                          # linearly with group size / 2.


def decode_step_time(cfg: ModelConfig, batch: int, mean_context: float,
                     plan: ParallelismPlan, hw: Hardware,
                     dtype_bytes: int = 2,
                     cache_dtype_bytes: int = 2) -> Dict[str, float]:
    """One decode *round* (every running sequence gains one token).

    Pipeline parallelism re-reads each stage's weights once per micro-batch:
    with m = min(pp, batch) micro-batches in flight, per-device weight
    traffic is m x (W / (tp*pp)) per round — the paper's dense-PP decode
    pathology. If m < pp, (pp-m)/pp of stage-steps are bubbles.
    """
    shard = plan.tp * plan.pp
    n_act = cfg.active_param_count()
    w_dev = weight_bytes(cfg, dtype_bytes) / shard
    m_micro = max(min(plan.pp, batch), 1)
    if cfg.moe and cfg.moe.n_experts:
        # only experts hit by a micro-batch are read
        mo = cfg.moe
        per_micro = max(batch // m_micro, 1)
        e_hit = min(mo.n_experts, per_micro * mo.top_k)
        expert_w = mo.n_experts * 3 * cfg.d_model * mo.d_ff_expert \
            * dtype_bytes * (cfg.n_layers - mo.first_dense_layers)
        w_dev = (weight_bytes(cfg, dtype_bytes) - expert_w
                 + expert_w * e_hit / mo.n_experts) / shard
    w_read = w_dev * m_micro                     # PP re-read multiplier
    cache_read = (cfg.kv_bytes_per_token(cache_dtype_bytes) * mean_context
                  * batch + cfg.state_bytes_per_seq(cache_dtype_bytes)
                  * batch) / shard
    # weight streams lose achieved bandwidth as slicing deepens (small
    # per-device GEMV strides); paged cache reads keep full bandwidth
    w_bw = hw.hbm_bw * hw.bw_eff * _tp_eff(shard)
    t_mem = w_read / w_bw + cache_read / (hw.hbm_bw * hw.bw_eff)
    if m_micro < plan.pp:                        # unfillable bubbles
        t_mem *= plan.pp / m_micro
    if plan.pp > 1:
        t_mem += m_micro * PP_PASS_OVERHEAD.get(hw.name, 2e-3)
    t_compute = 2 * n_act * batch / (shard * hw.flops * hw.mxu_eff
                                     * _tp_eff(plan.tp))
    ar_bytes = batch * cfg.d_model * dtype_bytes
    t_tp = 2 * cfg.n_layers * _collective_time(ar_bytes, plan.tp, hw) / plan.pp
    if cfg.moe and cfg.moe.n_experts:
        a2a = batch * cfg.d_model * dtype_bytes * cfg.moe.top_k
        t_tp += 2 * cfg.n_layers * _collective_time(
            a2a, max(plan.ep, plan.tp), hw, "all-to-all") / plan.pp
        # calibrated MoE sync overhead (dispatch/combine per layer, both
        # sub-collectives), linear in the sync-domain size
        n_sync = max(plan.tp, plan.ep)
        t_tp += 4 * cfg.n_layers * MOE_SYNC_ALPHA * (n_sync / 2) / plan.pp \
            if n_sync > 1 else 0.0
    return {"compute": t_compute, "memory": t_mem, "comm": t_tp,
            "total": max(t_compute, t_mem) + t_tp}


def pp_bubble_factor(cfg: ModelConfig, plan: ParallelismPlan, hw: Hardware,
                     batch: int, mean_context: float,
                     dtype_bytes: int = 2) -> float:
    """GPipe-style bubble overhead (p-1)/m, with the micro-batch depth m
    CAPPED by per-stage KV capacity — the paper's 405B pathology (§V-C):
    dense models' KV starves the pipeline of micro-batches."""
    if plan.pp <= 1:
        return 1.0
    cap_tokens = kv_capacity_tokens(cfg, plan, hw, dtype_bytes)
    per_seq = max(mean_context, 1.0)
    max_seqs_in_flight = max(int(cap_tokens / per_seq), 1)
    m = max(min(batch, max_seqs_in_flight) // max(batch // (plan.pp * 4), 1), 1)
    m = min(m, 4 * plan.pp)
    return 1.0 + (plan.pp - 1) / m


def pp_transport_time(cfg: ModelConfig, tokens: int, plan: ParallelismPlan,
                      hw: Hardware, dtype_bytes: int = 2) -> float:
    if plan.pp <= 1:
        return 0.0
    bw = hw.inter_bw or hw.link_bw
    return (plan.pp - 1) * tokens * cfg.d_model * dtype_bytes / bw


def weight_load_time(cfg: ModelConfig, plan: ParallelismPlan, hw: Hardware,
                     dtype_bytes: int = 2) -> float:
    """Cold-start cost of minting a replica: stream each device's weight
    shard into HBM at achievable bandwidth. This is the ingest *lower bound*
    (weights already staged host-side); container pull / checkpoint fetch are
    workload-dependent and modeled separately (the autoscaler's
    ``cold_start_extra_s``). TP/PP shard the weights, so deeper slicing
    loads faster per device — another face of the DP weight-replication tax
    (Obs 3)."""
    return weight_bytes(cfg, dtype_bytes) \
        / (plan.tp * plan.pp * hw.hbm_bw * hw.bw_eff)


def kv_transfer_time(cfg: ModelConfig, context_tokens: int, hw: Hardware,
                     cache_dtype_bytes: int = 2, n_seqs: int = 1) -> float:
    """Prefill→decode migration cost in a disaggregated deployment: ship the
    request's whole KV cache (plus any recurrent state) across the inter-node
    fabric. Strictly monotone in context length; the alpha term models the
    per-transfer handshake/launch latency."""
    payload = kv_bytes(cfg, context_tokens, cache_dtype_bytes, n_seqs=n_seqs)
    bw = hw.inter_bw or hw.link_bw
    return payload / bw + hw.link_alpha
