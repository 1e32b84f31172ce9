"""A copy of the benchmark at smoke sizes, for the CPU tests: the cells of
``BENCHMARK.json`` on tiny configurations of the same shapes (a windowed
dense decoder, an MoE one) and their mixes cut to short lengths."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY = {"source": "smoke", "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "vocab_size": 512, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16", "reduced": [],
        "engine": {"n_pages": 128, "page_size": 16, "max_num_seqs": 8,
                   "max_num_batched_tokens": 256, "chunk_size": 64,
                   "admission_mode": "kv_aware"},
        "check": {"reference_tokens": 4000, "min_served_tokens": 8}}
CONFIGS = {"tiny-dense": dict(TINY, name="tiny-dense"),
           "tiny-moe": dict(TINY, name="tiny-moe", num_local_experts=4,
                            num_experts_per_tok=2, port={"capacity_factor": 2.0})}
SHORT = {"isl": {"median": 12, "sigma": 0.45, "min": 4, "max": 40},
         "osl": {"median": 24, "sigma": 0.7, "min": 4, "max": 64}}
# (tiny-moe over seeds 5-10: a mean gap of 0.0031-0.0052 sound, 0.078-0.097
# under the fp8 control, 0.54 and more under each planted fault)
MOE_MEAN = 0.03
# a windowed decoder of the same shape, for the reference's window
WINDOWED = dict(TINY, name="tiny-swa", sliding_window=16)
# each number a cell compares, at smoke size: a sound smoke run's widest
# gap is a few hundredths (bf16 against fp32 on a two-layer model), and the
# MoE's router flips at near ties move its widest gap more than its means
LIMIT = {"tiny-dense": {"logit_gap": 0.25},
         "tiny-moe": {"logit_gap": 2.5, "mean_logit_gap": MOE_MEAN}}


def make(dest: Path) -> Path:
    """``dest`` holding the benchmark's files at smoke sizes and a link to
    the port's sources."""
    shutil.copytree(BENCH, dest / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", dest / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    swap = {"h2o-danube-3-4b": "tiny-dense", "phi3.5-moe.pp2": "tiny-moe"}
    for name, cfg in CONFIGS.items():
        (dest / "bench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    spec["configs"] = [{"name": n, "source": "smoke", "file": f"bench/configs/{n}.json",
                        "reduced": [], "why": "smoke"} for n in CONFIGS]
    for w in cells.values():
        w["config"] = swap.get(w["config"], w["config"])
        own = dest / "bench" / "cells" / f"{w['name']}.json"
        extra = json.loads(own.read_text()) if own.exists() else {}
        # the cell's own numbers, at their smoke limits
        own_numbers = [k for k in extra.get("check", {}) if k.endswith("_limit")]
        extra.update(SHORT, clients=6, warmin_s=1,
                     check={k: LIMIT[w["config"]][k[:-len("_limit")]] for k in own_numbers})
        if extra.get("rate_per_s"):
            extra["rate_per_s"] = 20.0
        own.write_text(json.dumps(extra))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


def run(root: Path, cell: str, seed: int = 5, seconds: float = 1.5, trace: int = 0,
        extra=()) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu", *extra],
        cwd=root, capture_output=True, text=True, timeout=300)


def result(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
