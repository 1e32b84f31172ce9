"""Measure what a configuration's pool may take on this card.

    python3 bench/tools/size_pool.py --config <name> --prompt <tokens> [--rows <n>]

Builds the configuration's model with the benchmark's weights and an
engine on a small pool, serves one prompt of ``--prompt`` tokens (the
longest whole prefill the cell's traffic can ask for: a prompt, or a
preempted sequence's recompute) and ``--rows`` one-token prompts decoded
together, and prints the activation peak above the weights and the pages
that fit in what the card has left, less ``--margin`` GiB."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--prompt", type=int, required=True)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--margin", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    from harness import spec, system
    config = json.loads((BENCH / "configs" / f"{args.config}.json").read_text())
    s = spec.model_sizes(config)
    page = config["engine"]["page_size"]
    page_bytes = s["L"] * 2 * page * s["KV"] * s["D"] * 2
    # room for every request at once under kv-aware admission's reserve
    need = -(-(args.prompt + 3) // page) + args.rows
    small = dict(config, engine={**config["engine"], "n_pages": int(need / 0.9) + 64})
    eng = system.build(small, s, 1, args.device)
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        weights = torch.cuda.memory_allocated()
        free, total = torch.cuda.mem_get_info()
        torch.cuda.reset_peak_memory_stats()
    else:
        weights = free = total = 0
    pool = sum(p.numel() * p.element_size() for p in eng.runner.pools)
    eng.submit([i % s["V"] for i in range(args.prompt)], 2)
    for i in range(args.rows):
        eng.submit([i % s["V"]], 2)
    for _ in range(10_000):
        if not eng.has_work:
            break
        eng.step()
    else:
        raise RuntimeError("the probe's requests did not finish in 10,000 steps")
    act = torch.cuda.max_memory_allocated() - weights if cuda else 0
    left = free + pool - act - args.margin * 2 ** 30
    print(json.dumps({"config": args.config,
                      "card": torch.cuda.get_device_name() if cuda else "cpu",
                      "total_bytes": total, "free_after_build_bytes": free,
                      "weights_bytes": weights - pool, "activation_peak_bytes": act,
                      "page_bytes": page_bytes, "margin_gib": args.margin,
                      "n_pages": int(left // page_bytes)}))


if __name__ == "__main__":
    main()
