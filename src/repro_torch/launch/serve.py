"""Serving launcher of the port: real execution on the card, or a
simulated fleet on the host.

Full-size llama3.2-3b in bf16 on the card, weights from a seed:
    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16

``--arch`` picks any model of ``repro_torch.configs.registry``:
llama3.2-3b, qwen3-14b (qk-norm), h2o-danube-3-4b (sliding window 4096,
head dim 120), llama3-405b, internvl2-76b (a vlm backbone: 64 q / 8 kv
heads of 128), musicgen-medium (an audio decoder: MHA, 24 heads of 64),
phi3.5-moe-42b-a6.6b, kimi-k2-1t-a32b (head dim 112, 384 experts),
deepseek-r1-671b, the ds-distill models, zamba2-2.7b (Mamba2 layers and a
shared attention block of head dim 80) and xlstm-350m (mLSTM and sLSTM
blocks, no attention; its engine keeps the page accounting, with no pool
behind it). The engine passes no prefix embeddings, so a vlm or audio
model serves its text or codec tokens alone. A model that needs more
memory than one card has (llama3-405b, internvl2-76b, kimi-k2, the full
MoE models) is served at full width on the card with its depth cut by
``dataclasses.replace`` (as ``chip_smoke.py`` does) through ``serve()``.
``serve_sharded()`` serves across the ranks of a mesh (tensor and expert
parallel over "model"), one call on every rank; the command line stays on
one device, as the reference's does.

Reduced config on the CPU (the sliding window is 16 there, so prompts
of up to 24 tokens and outputs of up to 32 cross it):
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --arch h2o-danube-3-4b --requests 4 --isl 4 24 --osl 8 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --dtype float32 --arch zamba2-2.7b --requests 4 --isl 4 24 --osl 8 32

Simulated fleet mode (``--sim``; host only: ``SimRunner`` replicas behind
``DPRouter`` on a virtual clock, the perf model's ``--hw`` constants, the
reasoning workload), with the JAX package's ``--sim`` arguments, defaults
and printed lines:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch ds-distill-32b \
        --sim --hw h100 --dp 2 --tp 4 --requests 100
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ALL_MODELS, get_config, get_smoke_config
from repro_torch.core import perf_model as pm
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.request import Request
from repro_torch.core.router import DPRouter, RouterConfig
from repro_torch.core.runner import SimRunner, TorchRunner
from repro_torch.data.reasoning import REASONING, sample
from repro_torch.models.transformer import Transformer
from repro_torch.parallel.sharding import ParallelContext

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_requests(vocab: int, n: int, isl: Tuple[int, int],
                  osl: Tuple[int, int], seed: int) -> List[Tuple[List[int], int]]:
    """n (prompt, max_new_tokens) pairs; lengths uniform in the inclusive
    ranges, token ids uniform, all from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(isl[0], isl[1] + 1)))
        out.append((prompt.tolist(), int(rng.integers(osl[0], osl[1] + 1))))
    return out


def pages_to_hold(requests: Sequence[Tuple[List[int], int]],
                  page_size: int = 16, reserve: float = 0.05) -> int:
    """A pool that holds every request at its peak context at once, with
    the kv-aware admission reserve left free."""
    need = sum(-(-(len(p) + n + 1) // page_size) for p, n in requests)
    return int(np.ceil(need / (1.0 - reserve))) + 1


def build_engine(cfg: ModelConfig, n_pages: int, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 max_num_seqs: int = 16,
                 admission_mode: str = "kv_aware") -> InferenceEngine:
    """``InferenceEngine`` -> ``TorchRunner`` on a model whose weights are
    seeded on ``device``, with a pool of ``n_pages`` pages."""
    model = Transformer(cfg, device=device, dtype=dtype, seed=seed)
    ecfg = EngineConfig(n_pages=n_pages, max_num_seqs=max_num_seqs,
                        admission_mode=admission_mode)
    return InferenceEngine(cfg, ecfg, TorchRunner(model, device=device),
                           virtual_clock=False)


def peak_context(requests: Sequence[Tuple[List[int], int]]) -> int:
    """The most positions a request holds: its prompt and its outputs."""
    return max(len(p) + n for p, n in requests)


def serve_sharded(cfg: ModelConfig, requests: Sequence[Tuple[List[int], int]],
                  ctx: ParallelContext, *, device="cuda",
                  dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                  max_num_seqs: int = 16, admission_mode: str = "kv_aware",
                  **engine) -> Tuple[Optional[InferenceEngine], List[Request]]:
    """``serve`` over ``ctx``'s mesh, called on every rank: each builds its
    shard of the seeded model (the same model as one device's); the
    leading rank runs the engine and returns it with the requests, the
    others follow it and return (None, []). The runner's ``max_len`` (a
    rank's pool holds its share of that many positions a slot) is the
    requests' ``peak_context``, as the reference's launcher bounds its
    ``JaxRunner`` by ``max_len``. ``engine`` overrides the ``EngineConfig``
    (its ``n_pages`` defaults to a pool that holds every request)."""
    model = Transformer(cfg, device=device, dtype=dtype, seed=seed, ctx=ctx)
    runner = TorchRunner(model, device=device, max_len=peak_context(requests))
    if not runner.leads:
        runner.follow()
        return None, []
    try:
        ecfg = EngineConfig(**{"n_pages": pages_to_hold(requests),
                               "max_num_seqs": max_num_seqs,
                               "admission_mode": admission_mode, **engine})
        eng = InferenceEngine(cfg, ecfg, runner, virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in requests]
        eng.run()
    finally:
        runner.close()
    return eng, reqs


def serve(cfg: ModelConfig, requests: Sequence[Tuple[List[int], int]], *,
          device="cuda", dtype: torch.dtype = torch.bfloat16, seed: int = 0,
          max_num_seqs: int = 16,
          admission_mode: str = "kv_aware") -> Tuple[InferenceEngine, List[Request]]:
    """Serve ``requests`` to completion on a pool that holds them all."""
    eng = build_engine(cfg, pages_to_hold(requests), device=device,
                       dtype=dtype, seed=seed, max_num_seqs=max_num_seqs,
                       admission_mode=admission_mode)
    reqs = [eng.submit(p, n) for p, n in requests]
    eng.run()
    return eng, reqs


HARDWARE = {"h100": pm.H100, "h200": pm.H200, "v5e": pm.V5E}


def build_sim_fleet(cfg: ModelConfig, args) -> DPRouter:
    """``args.dp`` ``SimRunner`` replicas of ``cfg`` on ``args.hw``, each
    with every KV token that fits beside its weight shard, behind one
    ``DPRouter``."""
    hw = HARDWARE[args.hw]
    plan = pm.ParallelismPlan(dp=args.dp, tp=args.tp, pp=args.pp, ep=args.tp)
    cap = pm.kv_capacity_tokens(cfg, plan, hw)
    ecfg = EngineConfig(n_pages=max(cap // 16, 64),
                        max_num_seqs=args.max_num_seqs,
                        max_num_batched_tokens=args.max_batched_tokens,
                        chunk_size=512, admission_mode=args.admission,
                        autotune=args.autotune)
    replicas = [InferenceEngine(cfg, ecfg, SimRunner(cfg, plan, hw))
                for _ in range(args.dp)]
    return DPRouter(replicas, RouterConfig(policy=args.router))


def run_sim(args):
    """Serve ``args.requests`` reasoning requests, all arriving at t=0, on
    the simulated fleet and print each replica's and the fleet's line."""
    cfg = get_config(args.arch)
    router = build_sim_fleet(cfg, args)
    for isl, osl in sample(REASONING, args.requests, seed=args.seed):
        router.submit(int(isl), int(osl), arrival=0.0)
    metrics = router.run_all()
    for i, m in enumerate(metrics):
        s = m.summary()
        print(f"[replica {i}] done={s['n_finished']} "
              f"tput={s['gen_throughput_tok_s']:.0f} tok/s "
              f"ttft_p50={s['ttft_s']['p50']:.2f}s "
              f"tpot={s['tpot_s']['mean']*1e3:.1f}ms "
              f"preempt={s['preemptions']}")
    total = sum(m.summary()["gen_tokens"] for m in metrics)
    dur = max(m.summary()["duration_s"] for m in metrics)
    print(f"[fleet] {total} tokens in {dur:.1f}s "
          f"-> {total/dur:.0f} tok/s aggregate")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALL_MODELS), default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    # --requests and --max-num-seqs default to 100 and 256 with --sim (the
    # JAX package's launcher), and to 16 and 16 on the card
    ap.add_argument("--requests", type=int)
    ap.add_argument("--isl", type=int, nargs=2, default=(128, 1024))
    ap.add_argument("--osl", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--max-num-seqs", type=int)
    ap.add_argument("--admission", choices=["naive", "kv_aware"],
                    default="kv_aware")
    ap.add_argument("--seed", type=int, default=0)
    # --sim only
    ap.add_argument("--hw", choices=sorted(HARDWARE), default="v5e")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--max-batched-tokens", type=int, default=8192)
    ap.add_argument("--router", choices=["round_robin", "jsq", "memory_aware"],
                    default="memory_aware")
    ap.add_argument("--autotune", action="store_true")
    args = ap.parse_args()

    if args.sim:
        args.requests = 100 if args.requests is None else args.requests
        args.max_num_seqs = args.max_num_seqs or 256
        run_sim(args)
        return
    args.requests = 16 if args.requests is None else args.requests
    args.max_num_seqs = args.max_num_seqs or 16
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    requests = make_requests(cfg.vocab, args.requests, tuple(args.isl),
                             tuple(args.osl), args.seed)
    eng, _ = serve(cfg, requests, device=args.device,
                   dtype=DTYPES[args.dtype], seed=args.seed,
                   max_num_seqs=args.max_num_seqs,
                   admission_mode=args.admission)
    s = eng.metrics.summary()
    print(json.dumps({k: v for k, v in s.items() if not isinstance(v, dict)},
                     indent=1))
    print(f"[serve] completed {s['n_finished']} requests, "
          f"{s['gen_tokens']} tokens")


if __name__ == "__main__":
    main()
