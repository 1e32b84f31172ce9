"""The port's trace layer (``repro_torch.trace``: JSONL files, the stream
differ and ``python -m repro_torch.trace``) against ``repro.trace``. The
modules are framework-free copies, so the same recorded stream must give the
reference's file bytes, loaded rows, ``DiffResult`` and report text, and the
two CLIs must print the same lines with the same exit codes (the program's
own name in a usage message aside). The streams are a DS-Distill-8B sim
engine that preempts and a disaggregated cluster run that migrates, each
recorded by both packages.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

from repro import cluster as jcluster
from repro import trace as jtrace
from repro.configs.paper_models import DS_DISTILL_8B as J_DS8B
from repro.core import perf_model as jpm
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import InferenceEngine as JEngine
from repro.core.runner import SimRunner as JSimRunner
from repro.data.reasoning import REASONING as J_REASONING
from repro_torch import cluster, trace
from repro_torch.configs.paper_models import DS_DISTILL_8B
from repro_torch.core import perf_model as pm
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.runner import SimRunner
from repro_torch.data.reasoning import REASONING

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def engine_stream(eng_cls, cfg_cls, runner_cls, mod, cfg):
    """24 requests of 100 + 300 tokens on 300 pages at 16 sequences: the
    naive scheduler preempts."""
    eng = eng_cls(cfg, cfg_cls(n_pages=300, max_num_seqs=16,
                               max_num_batched_tokens=4096, chunk_size=256,
                               admission_mode="naive"),
                  runner_cls(cfg, mod.ParallelismPlan(), mod.H200))
    eng.events.enable_recording()
    for _ in range(24):
        eng.submit(100, 300, arrival=0.0)
    eng.run(max_steps=50000)
    assert eng.sched.n_preemptions > 0
    return eng.events.events


def cluster_stream(cl, mod, cfg, spec):
    """2 prefill + 2 decode replicas, 20 Poisson arrivals."""
    plan = mod.ParallelismPlan()
    ws = [cl.make_sim_worker(cfg, plan, mod.H200, role=role, name=f"{role}{i}",
                             n_pages=2000, max_seqs=32)
          for role in ("prefill", "decode") for i in range(2)]
    rt = cl.ClusterRuntime(ws, cl.ClusterConfig())
    rt.events.enable_recording()
    rt.submit_trace(cl.make_trace(cl.PoissonProcess(rate=20.0), spec, 20, seed=3,
                                  osl_cap=200))
    rt.run()
    return rt.events.events


@pytest.fixture(scope="module")
def streams():
    """name -> (reference events, port events); their rows are equal."""
    out = {
        "engine": (engine_stream(JEngine, JEngineConfig, JSimRunner, jpm, J_DS8B),
                   engine_stream(InferenceEngine, EngineConfig, SimRunner, pm,
                                 DS_DISTILL_8B)),
        "cluster": (cluster_stream(jcluster, jpm, J_DS8B, J_REASONING),
                    cluster_stream(cluster, pm, DS_DISTILL_8B, REASONING)),
    }
    for ref, mine in out.values():
        assert [e.to_dict() for e in mine] == [e.to_dict() for e in ref]
    assert {"eject", "inject", "kv_transfer", "run_end"} \
        <= {e.kind for e in out["cluster"][1]}
    return out


@pytest.fixture(scope="module")
def files(streams, tmp_path_factory):
    """name -> (reference's file, port's file) of each stream."""
    d = tmp_path_factory.mktemp("trace")
    out = {}
    for name, (ref, mine) in streams.items():
        out[name] = (d / f"{name}.ref.jsonl", d / f"{name}.port.jsonl")
        assert jtrace.dump_events(ref, str(out[name][0])) == len(ref)
        assert trace.dump_events(mine, str(out[name][1])) == len(mine)
    return out


def test_exports_equal_the_reference():
    assert trace.__all__ == jtrace.__all__
    assert trace.KINDS == jtrace.KINDS


@pytest.mark.parametrize("name", ["engine", "cluster"])
def test_dump_events_gives_the_reference_bytes(name, streams, files, tmp_path):
    ref_file, port_file = files[name]
    assert port_file.read_bytes() == ref_file.read_bytes()
    # the streaming writer, subscribed event by event, writes the same file
    with trace.JsonlWriter(str(tmp_path / "w.jsonl")) as w:
        for ev in streams[name][1]:
            w(ev)
    assert w.n == len(streams[name][1])
    assert (tmp_path / "w.jsonl").read_bytes() == ref_file.read_bytes()


@pytest.mark.parametrize("name", ["engine", "cluster"])
def test_load_and_iter_round_trip(name, streams, files, tmp_path):
    ref_file, port_file = files[name]
    rows = trace.load_events(str(port_file))
    assert rows == [e.to_dict() for e in streams[name][1]]
    assert rows == jtrace.load_events(str(ref_file))
    assert list(trace.iter_events(str(port_file))) == rows
    # rows dumped again give the same bytes
    trace.dump_events(rows, str(tmp_path / "again.jsonl"))
    assert (tmp_path / "again.jsonl").read_bytes() == port_file.read_bytes()


def perturb(rows, how):
    rows = [dict(r, payload=dict(r["payload"])) for r in rows]
    i = len(rows) // 2
    if how == "time":
        rows[i]["t"] += 1e-9
    elif how == "payload":
        key = sorted(rows[i]["payload"])[0]
        rows[i]["payload"][key] = "changed"
    elif how == "kind":
        rows[i]["kind"] = "admit" if rows[i]["kind"] != "admit" else "resume"
    elif how == "dropped":
        del rows[i]
    elif how == "truncated":
        rows = rows[:i]
    return rows


@pytest.mark.parametrize("name", ["engine", "cluster"])
@pytest.mark.parametrize("how", ["equal", "time", "payload", "kind", "dropped",
                                 "truncated"])
def test_diff_events_gives_the_reference_result(name, how, files):
    rows = trace.load_events(str(files[name][1]))
    other = perturb(rows, how) if how != "equal" else rows
    for context in (0, 3):
        for a, b in ((rows, other), (other, rows)):
            mine = trace.diff_events(a, b, context=context, label_a="A", label_b="B")
            ref = jtrace.diff_events(a, b, context=context, label_a="A", label_b="B")
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.report() == ref.report()
            assert mine.identical == ref.identical == (how == "equal")


def run_cli(package, *args):
    res = subprocess.run([sys.executable, "-m", f"{package}.trace", *args],
                         env={**os.environ, "PYTHONPATH": SRC}, capture_output=True,
                         text=True, timeout=120)
    return res.returncode, res.stdout, res.stderr.replace(package, "PKG")


@pytest.mark.parametrize("case", ["identical", "diverged", "context", "missing",
                                  "malformed", "usage"])
def test_cli_prints_what_the_reference_prints(case, files, tmp_path):
    """Exit 0 on equal streams, 1 on a divergence, 2 on unreadable input or
    bad usage; the same output from both packages."""
    ref_file, port_file = (str(p) for p in files["engine"])
    diverged = tmp_path / "diverged.jsonl"
    trace.dump_events(perturb(trace.load_events(port_file), "time"), str(diverged))
    malformed = tmp_path / "malformed.jsonl"
    malformed.write_text('{"t": 0.0, "kind": "arrival"\n')
    args = {"identical": ("diff", ref_file, port_file),
            "diverged": ("diff", port_file, str(diverged)),
            "context": ("diff", port_file, str(diverged), "--context", "1"),
            "missing": ("diff", port_file, str(tmp_path / "none.jsonl")),
            "malformed": ("diff", str(malformed), port_file),
            "usage": ("diff", port_file)}[case]
    mine = run_cli("repro_torch", *args)
    assert mine == run_cli("repro", *args)
    assert mine[0] == {"identical": 0, "diverged": 1, "context": 1}.get(case, 2)
