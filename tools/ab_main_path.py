#!/usr/bin/env python3
"""Two checkouts of the port compared on one NVIDIA card, run by run.

    git archive <parent> | tar -x -C build/ab_parent
    python3 tools/ab_main_path.py --tree parent=build/ab_parent --tree change=. \
        --order parent,change,change,parent,parent,change [--arch xlstm-350m]

Each run is a process of its own that imports ``repro_torch`` from one
checkout's ``src`` (its kernels build there) and prints, as JSON lines:
the attention wrappers' times at the main path's shapes (``timing``: eager
``ms`` by CUDA events, ``device_ms`` from a replayed CUDA graph, the
host's time per wrapper call ``host_ms``, as ``chip_smoke.py`` times
them), then the main path's end-to-end metrics (``main_path``:
full-depth llama3.2-3b in bf16 serving 16 requests, as ``chip_smoke.py``
phase 5 serves them; ``--arch`` serves another registry model instead,
xlstm-350m with ``XLSTM_REQUESTS`` as ``chip_smoke.py`` does, any other
with ``SERVE_REQUESTS``; ``--sharded`` runs ``chip_smoke.py``'s
``sharded_main_path`` instead: its four models on two gloo ranks of a
(1, 2) mesh through ``serve_sharded``). Runs alternate between the checkouts in the order
given so that a drift of the shared host falls on both. The last line
gives each checkout's values of every run side by side. All lines also
go to ``chiprun_out/ab_main_path.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "ab_main_path.jsonl"
# (kernel, shape) of the rows each run times, and the metrics the summary
# lists
FLASH_CASES = [(1, 2048, 2048, 24, 8, 128, 0), (1, 137, 137, 24, 8, 128, 0)]
SUMMARY_TIMING = ("ms", "device_ms", "host_ms")
SUMMARY_MAIN = ("gen_tok_s", "ttft_p50_s", "tpot_mean_s", "max_memory_allocated")


def run_one(tree: Path, arch: str, sharded: bool):
    """One run against the checkout at ``tree``, in this process."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("ab_main_path: no CUDA card")
    src = (tree / "src").resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise AssertionError(f"imported {repro_torch.__file__}, not {src}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case in FLASH_CASES:
        cs.emit("timing", kernel="flash_attention",
                **cs.time_flash(flash_ops, case, torch.bfloat16, gen))
    for m in (cs.MAIN_PAGED, cs.LONG_PAGED):
        cs.emit("timing", kernel="paged_attention",
                **cs.time_paged(paged_ops, torch.bfloat16, gen, m))
    if sharded:
        cs.sharded("main_path")
        return
    from repro_torch.configs.registry import get_config
    traffic = cs.XLSTM_REQUESTS if arch == "xlstm-350m" else cs.SERVE_REQUESTS
    cs.main_path(flash_ops, paged_ops, get_config(arch), traffic)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR, a checkout of the repo")
    ap.add_argument("--order", help="comma-separated labels, one per run")
    ap.add_argument("--run", help="run once against this checkout")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--sharded", action="store_true",
                    help="serve chip_smoke.py's sharded_main_path")
    args = ap.parse_args()
    if args.run:
        return run_one(Path(args.run), args.arch, args.sharded)

    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    summary = {label: {} for label in trees}
    with OUT.open("w") as log:
        for i, label in enumerate(order):
            proc = subprocess.run(
                [sys.executable, __file__, "--run", trees[label], "--arch",
                 args.arch] + ["--sharded"] * args.sharded,
                cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                raise SystemExit(f"run {i} ({label}) failed: {proc.returncode}")
            for line in proc.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                row = {"run": i, "tree": label, **json.loads(line)}
                text = json.dumps(row)
                print(text, flush=True)
                log.write(text + "\n")
                if row["phase"] == "timing":
                    key = f"{row['kernel']}{row['shape']}"
                    for m in SUMMARY_TIMING:
                        summary[label].setdefault(f"{key}.{m}", []).append(row[m])
                elif row["phase"] == "main_path":
                    for m in SUMMARY_MAIN:
                        summary[label].setdefault(m, []).append(row[m])
                elif row["phase"] == "sharded_main_path" and "tpot_mean_s" in row:
                    # the leading rank's engine metrics
                    summary[label].setdefault(f"{row['model']}.tpot_mean_s", []).append(
                        row["tpot_mean_s"])
        text = json.dumps({"summary": summary, "order": order})
        log.write(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
