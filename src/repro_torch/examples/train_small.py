"""Train a small llama-family model for a few hundred steps with
checkpointing: the port's end-to-end training example, as the reference's
``examples/train_small.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 300
(60 steps by default, so the example finishes quickly; on the card unless
``--device cpu``). The reference calls the config "~100M params";
``param_count()`` gives 54,538,240 (untied embedding and head), and the
model holds 54,538,752 with the final norm, which that count leaves out.

The batches have learnable structure (bigram-ish), so the loss falls; the
batch of step s comes from a generator seeded with s, so a run resumed
from a checkpoint trains on the batches an uninterrupted one would.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

# 12L x 512d x 8H, 16k vocab
CFG_100M = ModelConfig(name="llama-100m", family="dense", n_layers=12,
                       d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
                       d_ff=1536, vocab=16384, attention="full",
                       rope_theta=10000.0)
CKPT_EVERY = 50


def batch_for(step: int, batch: int, seq: int, vocab: int,
              device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(step)
    base = torch.randint(0, 256, (batch, seq + 1), generator=gen, device=device)
    toks = (base * 17 + torch.cumsum(base, dim=1) % 101) % vocab
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def run(*, steps: int = 60, batch: int = 4, seq: int = 256,
        ckpt_dir: str, device="cuda",
        resume_from: Optional[int] = None) -> Dict[int, float]:
    """Train ``CFG_100M`` to step ``steps``, checkpointing every
    ``CKPT_EVERY`` steps into ``ckpt_dir``; from the checkpoint of step
    ``resume_from`` into a fresh model and optimizer, or from weights
    seeded with 0. Returns each step's loss by step number (1-based)."""
    dev = resolve_device(device)
    cfg = CFG_100M
    ocfg = AdamWConfig(lr=6e-4, warmup_steps=20)
    model = Transformer(cfg, device=dev, dtype=torch.float32, seed=0,
                        layout="train")
    opt = init_opt_state(model.param_tree(), ocfg)
    start = 0
    if resume_from is not None:
        opt, start = ckpt.restore_training(model, opt, ckpt_dir, resume_from)
    step_fn = make_train_step(model, ocfg)
    losses = {}
    t0 = time.perf_counter()
    for step in range(start, steps):
        m = step_fn(opt, batch_for(step, batch, seq, cfg.vocab, dev))
        losses[step + 1] = float(m["loss"])
        if (step + 1) % 20 == 0:
            print(f"step {step + 1:4d} loss {losses[step + 1]:.4f} "
                  f"({(time.perf_counter() - t0) / (step - start + 1):.2f}s/step)",
                  flush=True)
        if (step + 1) % CKPT_EVERY == 0:
            ckpt.save((model.param_tree(), opt), ckpt_dir, step + 1)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args()

    print(f"model: {CFG_100M.param_count() / 1e6:.0f}M params")
    losses = run(steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt, device=args.device)
    first, last = losses[1], losses[args.steps]
    print(f"loss: {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
