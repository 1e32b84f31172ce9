"""The control on the card: the plain reference computed in fp8 e4m3 (the
precision below the configurations' bf16), judged in the program's place
by the cell's own numbers and limits, makes the run report ``correct``
false, while the program's own numbers in the same run meet the limits,
at the cell's own size, over a short window at the cell's own load.

    python -m pytest -m gpu bench/tests/test_bench_control.py

(each case is one run of ``bench/run.py --control``, 1.5 to 2 minutes
on an NVIDIA H100 with the kernels built)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from smoke import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_the_control_fails_where_the_program_passes(card, cell):
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", cell,
                           "--seed", "424242", "--seconds", "10", "--trace", "0", "--control"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    out = lines[-1]
    program = next(x["reference"]["numbers"] for x in lines if "reference" in x)
    own = json.loads((ROOT / "bench" / "cells" / f"{cell}.json").read_text())["check"]
    compared = [k[:-len("_limit")] for k in own if k.endswith("_limit")]
    assert compared and out["correct"] is False
    assert any(out["checks"][k]["value"] > out["checks"][k]["limit"] for k in compared)
    assert all(program[k] <= out["checks"][k]["limit"] for k in compared), program
