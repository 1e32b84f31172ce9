"""Quickstart: build a model, run a forward pass, serve a few requests, and
ask the planner how to deploy the full-size version. The reference's
``examples/quickstart.py`` on the port.

Full-width llama3.2-3b in bf16 on the card, served through both kernels:
    PYTHONPATH=src python -m repro_torch.examples.quickstart
The reference's reduced model in fp32 on the CPU's plain path:
    PYTHONPATH=src python -m repro_torch.examples.quickstart --smoke --device cpu

The reduced model's head dim is 16, which neither kernel takes, so
``--smoke`` on the card raises the kernel's error.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import perf_model as pm, planner
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.runner import TorchRunner
from repro_torch.models.transformer import Transformer

ARCH = "llama3.2-3b"


def build_model(smoke: bool, device="cuda") -> Transformer:
    """llama3.2-3b with weights from seed 0: the reference's reduced config
    in fp32 with ``smoke``, else the full-width model in bf16."""
    if smoke:
        return Transformer(get_smoke_config(ARCH), device=device,
                           dtype=torch.float32, seed=0)
    return Transformer(get_config(ARCH), device=device, dtype=torch.bfloat16,
                       seed=0)


def run(model: Transformer) -> List[str]:
    """The example's three steps on ``model``; returns the printed lines."""
    cfg, device = model.cfg, model.device
    lines = []

    # 1) a forward pass over one 16-token sequence ---------------------------
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, 16)),
                             device=device)
    with torch.no_grad():
        logits = model.forward(tokens)
    lines.append(f"[1] forward: logits {tuple(logits.shape)}, "
                 f"finite={bool(torch.isfinite(logits).all())}")

    # 2) serve a few requests through the continuous-batching engine --------
    eng = InferenceEngine(
        cfg, EngineConfig(n_pages=24, max_num_seqs=4,
                          max_num_batched_tokens=512, chunk_size=96),
        TorchRunner(model, device=device), virtual_clock=False)
    for i in range(5):
        prompt = np.random.default_rng(i).integers(0, cfg.vocab, 8).tolist()
        eng.submit(prompt, max_new_tokens=8)
    summary = eng.run().summary()
    lines.append(f"[2] engine: {summary['n_finished']} requests, "
                 f"{summary['gen_tokens']} tokens, "
                 f"preemptions={summary['preemptions']}")

    # 3) plan the full-size deployment on a v5e pod slice --------------------
    full = get_config(ARCH)
    best = planner.best(full, pm.V5E, 64)
    lines.append(f"[3] planner: {ARCH} on 64x v5e -> {best.label()} "
                 f"(~{best.decode_tput_tok_s:.0f} decode tok/s, "
                 f"{best.concurrency} concurrent reqs/replica)")
    return lines


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced model in fp32 (head dim 16: CPU only)")
    args = ap.parse_args(argv)
    for line in run(build_model(args.smoke, args.device)):
        print(line, flush=True)


if __name__ == "__main__":
    main()
