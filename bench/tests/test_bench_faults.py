"""A run whose timed path is broken underneath reports ``correct`` false:
the harness's look for a chip skipped (``--device cpu``), the rest of the
run driven at smoke size with one fault of ``harness.faults`` planted in
the program, in each cell, judged by the cell's own numbers; and so does
a run with the fp8 control in the program's place."""
from __future__ import annotations

import json

import pytest

import smoke
from harness import cli, faults


def cells():
    return [w["name"] for w in json.loads((smoke.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return smoke.make(tmp_path_factory.mktemp("faults"))


def run(copy, cell, capsys, *extra):
    code = cli.main(["--workload", cell, "--seed", "21", "--seconds", "3", "--trace", "0",
                     "--device", "cpu", "--benchmark", str(copy / "BENCHMARK.json"), *extra],
                    cli.clock())
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def over_a_limit(out, copy, cell):
    """The numbers the cell compares that read over their limits."""
    own = json.loads((copy / "bench" / "cells" / f"{cell}.json").read_text())["check"]
    compared = [k[:-len("_limit")] for k in own if k.endswith("_limit")]
    assert compared and set(compared) <= set(out["checks"])
    return [k for k in compared if out["checks"][k]["value"] > out["checks"][k]["limit"]]


@pytest.mark.parametrize("cell", cells())
def test_a_sound_run_is_correct(copy, cell, capsys):
    out = run(copy, cell, capsys)
    assert out["correct"] is True and not over_a_limit(out, copy, cell)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", cells())
def test_a_planted_fault_is_not_correct(copy, cell, fault, monkeypatch, capsys):
    faults.plant(fault, monkeypatch.setattr)
    out = run(copy, cell, capsys)
    assert out["correct"] is False and over_a_limit(out, copy, cell), out["checks"]


@pytest.mark.parametrize("cell", cells())
def test_the_control_run_is_not_correct(copy, cell, capsys):
    """``--control``: the reference in fp8 judged in the program's place."""
    out = run(copy, cell, capsys, "--control")
    assert out["correct"] is False and over_a_limit(out, copy, cell), out["checks"]
