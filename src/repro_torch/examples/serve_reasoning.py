"""End-to-end serving example (the paper's experiment, miniaturised): serve a
batch of Natural-Reasoning-profile requests through the real engine, with
KV-aware admission ON vs OFF, and report the §III-D metric set — then rerun
the same comparison at paper scale on the simulator. The reference's
``examples/serve_reasoning.py`` on the port.

Full-width llama3.2-3b in bf16 on the card (the sim half on the host):
    PYTHONPATH=src python -m repro_torch.examples.serve_reasoning
The reference's reduced model in fp32 on the CPU:
    PYTHONPATH=src python -m repro_torch.examples.serve_reasoning --smoke --device cpu

The real half's scheduler reads no clock, so the reduced and the full
model take the same steps: 10 requests, 468 tokens, no preemption in
either mode. The sim half serves 400 requests and takes about ten minutes.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.configs.paper_models import DS_DISTILL_8B
from repro_torch.core import perf_model as pm
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.runner import SimRunner, TorchRunner
from repro_torch.data.reasoning import REASONING, sample
from repro_torch.examples.quickstart import build_model
from repro_torch.models.transformer import Transformer


def real_engine(admission: str, model: Transformer) -> InferenceEngine:
    """The reference's real-execution engine on ``model``, after serving its
    10 requests to completion."""
    cfg = model.cfg
    eng = InferenceEngine(
        cfg, EngineConfig(n_pages=30, max_num_seqs=6,
                          max_num_batched_tokens=1024, chunk_size=160,
                          admission_mode=admission),
        TorchRunner(model, device=model.device), virtual_clock=False)
    rng = np.random.default_rng(0)
    for _ in range(10):
        isl = int(rng.integers(8, 24))
        osl = int(rng.integers(24, 80))          # "reasoning-heavy" tail
        eng.submit(rng.integers(0, cfg.vocab, isl).tolist(), osl)
    eng.run()
    return eng


def real_engine_run(admission: str, model: Optional[Transformer] = None):
    """The real half's summary, on ``model`` (default: full-width
    llama3.2-3b in bf16 on the card)."""
    model = model if model is not None else build_model(False)
    return real_engine(admission, model).metrics.summary()


def sim_fleet_run(admission: str, n_requests: int = 400):
    cfg = DS_DISTILL_8B
    eng = InferenceEngine(
        cfg,
        EngineConfig(n_pages=pm.kv_capacity_tokens(
            cfg, pm.ParallelismPlan(), pm.H200) // 16,
            max_num_seqs=384, max_num_batched_tokens=8192,
            chunk_size=512, admission_mode=admission),
        SimRunner(cfg, pm.ParallelismPlan(), pm.H200))
    cap = eng.alloc.n_pages * 16
    for isl, osl in sample(REASONING, n_requests, seed=0):
        eng.submit(int(isl), int(min(osl, 8000, cap - isl - 2)), arrival=0.0)
    return eng.run(max_steps=300_000).summary()


def show(tag, s):
    print(f"  [{tag}] done={s['n_finished']} "
          f"tput={s['gen_throughput_tok_s']:.0f}tok/s "
          f"ttft_p50={s['ttft_s']['p50']:.2f}s "
          f"tpot={s['tpot_s']['mean']*1e3:.1f}ms "
          f"e2e_p95={s['e2e_s']['p95']:.1f}s "
          f"preempt={s['preemptions']} recompute={s['recomputed_tokens']}tok",
          flush=True)


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_reasoning")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced model in fp32 (head dim 16: CPU only)")
    args = ap.parse_args(argv)
    model = build_model(args.smoke, args.device)
    what = "reduced model" if args.smoke else "llama3.2-3b, bf16"
    print(f"== real execution ({what}, {model.device}) ==")
    for mode in ("naive", "kv_aware"):
        show(mode, real_engine_run(mode, model))
    print("== simulated DS-8B on one H200 (paper workload profile) ==")
    for mode in ("naive", "kv_aware"):
        show(mode, sim_fleet_run(mode))
    print("KV-aware admission eliminates the preemption storm (paper Obs 1/8): "
          "higher throughput AND lower tail latency.")


if __name__ == "__main__":
    main()
