"""Training launcher of the port: synthetic-LM training with checkpoint and
restart, with the reference launcher's flags and printed lines
(``repro.launch.train``) plus ``--device``.

Full-size llama3.2-3b on the card (fp32 weights and AdamW state, 51.4 GB):
    PYTHONPATH=src python -m repro_torch.launch.train --steps 50

Reduced config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4

Fault tolerance: checkpoints every ``--ckpt-every`` steps (async,
step-atomic, the reference's format); on start, resumes from the latest
checkpoint in ``--ckpt-dir`` if there is one. Step s trains on a batch
drawn from a ``torch.Generator`` on the device seeded with s, so a
resumed run sees the batches an uninterrupted one would.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ALL_MODELS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def synthetic_batch(step: int, batch: int, seq: int, vocab: int, *,
                    device) -> Dict[str, torch.Tensor]:
    """Uniform tokens (batch, seq + 1) of step ``step``, drawn from a
    generator seeded with the step, shifted by one into tokens and
    labels."""
    gen = torch.Generator(device=device).manual_seed(step)
    tokens = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                           device=device)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def train(cfg: ModelConfig, *, steps: int, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, log_every: int = 10, device="cuda"
          ) -> Dict[str, Any]:
    """Train ``cfg`` with fp32 weights and AdamW state (warmup 20) to step
    ``steps``, from the latest checkpoint in ``ckpt_dir`` if there is one,
    else from weights seeded with 0. Returns the model, the optimizer
    state, the step it started from and one record a step (loss, grad
    norm, lr, and the step's seconds on the host clock, the device
    synchronised)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, dtype=torch.float32, seed=0,
                        layout="train")
    ocfg = AdamWConfig(lr=lr, warmup_steps=20)
    opt_state = init_opt_state(model.param_tree(), ocfg)
    start_step = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        opt_state, start_step = ckpt.restore_training(model, opt_state, ckpt_dir)
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(model, ocfg)
    history: List[Dict[str, float]] = []
    pending = None
    t0 = time.perf_counter()
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        metrics = step_fn(opt_state, synthetic_batch(step, batch, seq,
                                                     cfg.vocab, device=dev))
        # float() waits for the device: the step's time is its own
        rec = {k: float(v) for k, v in metrics.items()}
        rec["step"] = step + 1
        rec["seconds"] = time.perf_counter() - t_step
        history.append(rec)
        if (step + 1) % log_every == 0 or step == start_step:
            print(f"[train] step {step + 1:5d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.3f} "
                  f"({(time.perf_counter() - t0) / (step - start_step + 1):.2f}s/step)",
                  flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save_async((model.param_tree(), opt_state),
                                      ckpt_dir, step + 1)
    if pending is not None:
        pending.join()
    final = f"{history[-1]['loss']:.4f}" if history else "n/a"
    print(f"[train] done: {steps - start_step} steps, final loss {final}")
    return {"model": model, "opt_state": opt_state, "start_step": start_step,
            "history": history}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=list(ALL_MODELS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
