"""The port's obs layer (``repro_torch.obs``: request spans, windows, regime
classification, the bottleneck report, the Perfetto export and ``python -m
repro_torch.obs``) against ``repro.obs``. The modules are framework-free
copies, so the same recorded stream must fold to the reference's spans
(exact ``Fraction`` phase totals), windows, verdicts, report and trace
events (floats to 1e-12 relative, where a sum's order could differ; in
practice they are equal), and the two CLIs must print the same output with
the same exit codes. The streams come from a DS-Distill-8B sim engine that
preempts and from colocated and disaggregated cluster runs, each recorded by
both packages, and from a real ``TorchRunner`` engine on the CPU, whose one
recorded stream both packages fold.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from fractions import Fraction

import pytest
import torch

from repro import cluster as jcluster
from repro import obs as jobs
from repro.configs.paper_models import DS_DISTILL_8B as J_DS8B
from repro.core import perf_model as jpm
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import InferenceEngine as JEngine
from repro.core.runner import SimRunner as JSimRunner
from repro.data.reasoning import REASONING as J_REASONING
from repro_torch import cluster, obs
from repro_torch.configs.paper_models import DS_DISTILL_8B
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import perf_model as pm
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.runner import SimRunner, TorchRunner
from repro_torch.data.reasoning import REASONING
from repro_torch.launch.serve import make_requests, pages_to_hold
from repro_torch.models.transformer import Transformer
from repro_torch.trace import dump_events

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
REL = 1e-12
STREAMS = ["engine", "colocated", "disaggregated"]


def assert_close(mine, ref):
    """Equal structure; numbers within ``REL`` relative."""
    if isinstance(ref, dict):
        assert list(mine) == list(ref)
        for k in ref:
            assert_close(mine[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(mine) is type(ref) and len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert_close(a, b)
    elif isinstance(ref, float):
        assert math.isclose(mine, ref, rel_tol=REL, abs_tol=0.0) or mine == ref
    else:
        assert mine == ref


def engine_run(eng_cls, cfg_cls, runner_cls, mod, cfg, tap=None):
    """24 requests of 100 + 300 tokens on 300 pages at 16 sequences, naive
    admission: the engine preempts, so windows read ``capacity_bound``."""
    eng = eng_cls(cfg, cfg_cls(n_pages=300, max_num_seqs=16,
                               max_num_batched_tokens=4096, chunk_size=256,
                               admission_mode="naive"),
                  runner_cls(cfg, mod.ParallelismPlan(), mod.H200))
    report = tap(eng.events) if tap else None
    if tap is None:
        eng.events.enable_recording()
    for _ in range(24):
        eng.submit(100, 300, arrival=0.0)
    eng.run(max_steps=50000)
    return report() if tap else (eng.events.events, eng.metrics.summary())


def cluster_run(cl, ob, mod, cfg, spec, mode):
    """Four replicas (colocated, or 2 prefill + 2 decode), 30 Poisson
    arrivals; the fleet summary with the run's regime fractions merged."""
    plan = mod.ParallelismPlan()
    roles = ["colocated"] * 4 if mode == "colocated" else ["prefill"] * 2 + ["decode"] * 2
    ws = [cl.make_sim_worker(cfg, plan, mod.H200, role=r, name=f"{r}{i}",
                             n_pages=1500, max_seqs=32) for i, r in enumerate(roles)]
    rt = cl.ClusterRuntime(ws, cl.ClusterConfig(policy="memory_aware"), sanitize=True)
    rt.events.enable_recording()
    rt.submit_trace(cl.make_trace(cl.PoissonProcess(rate=20.0), spec, 30, seed=3,
                                  osl_cap=300))
    m = rt.run()
    rep = ob.bottleneck_report(rt.events.events)
    return rt.events.events, m.summary(regimes=ob.regime_fractions(rep))


@pytest.fixture(scope="module")
def streams():
    """name -> ((reference events, summary), (port events, summary))."""
    out = {"engine": (engine_run(JEngine, JEngineConfig, JSimRunner, jpm, J_DS8B),
                      engine_run(InferenceEngine, EngineConfig, SimRunner, pm,
                                 DS_DISTILL_8B))}
    for mode in ("colocated", "disaggregated"):
        out[mode] = (cluster_run(jcluster, jobs, jpm, J_DS8B, J_REASONING, mode),
                     cluster_run(cluster, obs, pm, DS_DISTILL_8B, REASONING, mode))
    for (ref, ref_sum), (mine, mine_sum) in out.values():
        assert [e.to_dict() for e in mine] == [e.to_dict() for e in ref]
        assert_close(mine_sum, ref_sum)
    return out


def events(streams, name):
    (ref, _), (mine, _) = streams[name]
    return ref, mine


def test_exports_equal_the_reference():
    assert obs.__all__ == jobs.__all__
    assert obs.PHASES == jobs.PHASES and obs.REGIMES == jobs.REGIMES
    assert obs.DEFAULT_N_WINDOWS == jobs.DEFAULT_N_WINDOWS
    assert dataclasses.asdict(obs.RegimeRules()) == dataclasses.asdict(jobs.RegimeRules())


def span_rows(fold):
    return [(s.rid, s.arrival, s.slo_class, s.isl, s.t_finished, s.generated,
             s.n_preemptions, s.workers, [dataclasses.astuple(g) for g in s.segments],
             s.phase_fracs) for s in fold.spans + fold.open_spans]


@pytest.mark.parametrize("name", STREAMS)
def test_fold_spans_equals_the_reference_exactly(name, streams):
    """Phase totals as exact rationals, and the identity the fold promises:
    each finished span's total is ``t_finished - arrival`` to the last ulp."""
    ref, mine = events(streams, name)
    fold = obs.fold_spans(mine)
    assert span_rows(fold) == span_rows(jobs.fold_spans(ref))
    assert len(fold.spans) == len({e.rid for e in mine if e.kind == "arrival"})
    for s in fold.spans:
        assert s.exact_total == Fraction(s.t_finished) - Fraction(s.arrival)
        assert s.total_s == s.t_finished - s.arrival
    if name == "engine":
        assert any(s.phase_fracs["preempted_stall"] > 0 for s in fold.spans)
    if name == "disaggregated":
        assert all(s.phase_fracs["kv_transfer"] > 0 for s in fold.spans)


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("window_s", [None, 0.05])
def test_windows_and_verdicts_equal_the_reference(name, window_s, streams):
    ref, mine = events(streams, name)
    ws, jws = obs.build_windows(mine, window_s), jobs.build_windows(ref, window_s)
    assert (ws.t_min, ws.t_max, ws.window_s, ws.workers) \
        == (jws.t_min, jws.t_max, jws.window_s, jws.workers)
    assert_close([dataclasses.asdict(w) for w in ws.all_windows()],
                 [dataclasses.asdict(w) for w in jws.all_windows()])
    reg, jreg = obs.attribute(ws), jobs.attribute(jws)
    assert [(v.regime, v.reason) for v in reg.verdicts] \
        == [(v.regime, v.reason) for v in jreg.verdicts]
    assert_close(reg.to_dict(), jreg.to_dict())


# one window per rule of the decision table, in its order, then rule 7
CLASSIFY_CASES = {
    "cold_start": dict(warming=True),
    "no_work": dict(),
    "starved_awaiting_kv_transfer": dict(transfer_overlap_s=0.2),
    "preemption_storm": dict(n_samples=4, running_max=8, decode_tokens=100,
                             preemptions=2),
    "kv_throttled_admission": dict(n_samples=4, running_max=8, decode_tokens=100,
                                   kv_util_max=0.95, waiting_mean=3.0),
    "migration_dominated": dict(n_samples=4, running_max=2, decode_tokens=10,
                                transfer_overlap_s=0.6),
    "backlog_below_concurrency_cap": dict(n_samples=4, running_max=8, max_seqs=64,
                                          waiting_mean=5.0, decode_tokens=100),
    "busy_no_kv_pressure": dict(n_samples=4, running_max=64, max_seqs=64,
                                waiting_mean=5.0, decode_tokens=100),
}


@pytest.mark.parametrize("reason", sorted(CLASSIFY_CASES))
@pytest.mark.parametrize("rules", [{}, dict(kv_saturated=0.5, queue_min=6.0,
                                            cap_frac=0.1, comms_frac=0.9)])
def test_classify_equals_the_reference_for_every_regime(reason, rules):
    kw = dict(worker="w0", t0=0.0, t1=1.0, **CLASSIFY_CASES[reason])
    mine = obs.classify(obs.WindowStats(**kw), obs.RegimeRules(**rules))
    assert mine == jobs.classify(jobs.WindowStats(**kw), jobs.RegimeRules(**rules))
    if not rules:
        assert mine[1] == reason
    assert {obs.classify(obs.WindowStats(worker="w0", t0=0.0, t1=1.0, **c))[0]
            for c in CLASSIFY_CASES.values()} == set(obs.REGIMES)


@pytest.mark.parametrize("name", STREAMS)
def test_bottleneck_report_equals_the_reference(name, streams):
    ref, mine = events(streams, name)
    for window_s in (None, 0.5):
        rep = obs.bottleneck_report(mine, window_s=window_s)
        jrep = jobs.bottleneck_report(ref, window_s=window_s)
        assert_close(rep, jrep)
        assert_close(obs.regime_fractions(rep), jobs.regime_fractions(jrep))
        assert obs.render_text(rep, title=name).replace("repro_torch.", "repro.") \
            == jobs.render_text(jrep, title=name)
    if name == "engine":
        assert rep["regimes"]["fractions"]["capacity_bound"] > 0
        assert rep["requests"]["n_preempted"] > 0
    else:
        # the fleet summary carries the report's regime fractions
        summary = streams[name][1][1]
        assert summary["regimes"] == obs.regime_fractions(obs.bottleneck_report(mine))


def test_attached_tap_gives_the_reference_post_hoc_report(streams):
    """The in-process subscriber's report of a live run is the post-hoc
    report of the reference's recorded stream."""
    rep = engine_run(InferenceEngine, EngineConfig, SimRunner, pm, DS_DISTILL_8B,
                     tap=obs.attach)
    assert_close(rep, jobs.bottleneck_report(events(streams, "engine")[0]))


@pytest.mark.parametrize("name", STREAMS)
def test_chrome_trace_equals_the_reference(name, streams):
    ref, mine = events(streams, name)
    got = obs.to_chrome_trace(mine)
    assert_close(got, jobs.to_chrome_trace(ref))
    # a lone engine's events name no worker, so only a fleet has tracks
    assert {e["ph"] for e in got["traceEvents"]} \
        == (set() if name == "engine" else {"M", "X", "C"})


def run_cli(package, *args):
    res = subprocess.run([sys.executable, "-m", f"{package}.obs", *args],
                         env={**os.environ, "PYTHONPATH": SRC}, capture_output=True,
                         text=True, timeout=120)
    return res.returncode, res.stdout, res.stderr.replace(package, "PKG")


@pytest.mark.parametrize("case", ["text", "json", "window", "perfetto", "empty",
                                  "malformed", "not_an_event", "missing"])
def test_cli_equals_the_reference(case, streams, tmp_path):
    """``report`` (text, ``--json``, ``--window``) and ``perfetto`` print
    and write what the reference's do, exit 0; an empty, malformed, non-event
    or missing input exits 2 with the same message."""
    path = tmp_path / "disagg.jsonl"
    dump_events(events(streams, "disaggregated")[1], str(path))
    bad = {"empty": "\n\n", "malformed": '{"kind": "step"\n', "not_an_event": "[1, 2]\n"}
    if case in bad:
        path = tmp_path / f"{case}.jsonl"
        path.write_text(bad[case])
    if case == "missing":
        path = tmp_path / "none.jsonl"
    args = {"text": ("report", str(path)), "json": ("report", str(path), "--json"),
            "window": ("report", str(path), "--json", "--window", "0.25"),
            "perfetto": ("perfetto", str(path), "-o", str(tmp_path / "PKG.json"))
            }.get(case, ("report", str(path), "--json"))
    outs = {}
    for package in ("repro_torch", "repro"):
        pargs = [a.replace("PKG", package) for a in args]
        rc, out, err = run_cli(package, *pargs)
        outs[package] = (rc, out.replace(package + ".", "PKG.")
                         .replace(package + ".json", "PKG.json"), err)
    assert outs["repro_torch"] == outs["repro"]
    rc, out, err = outs["repro_torch"]
    assert rc == (2 if case in ("empty", "malformed", "not_an_event", "missing") else 0)
    if case == "json":
        rows = [e.to_dict() for e in events(streams, "disaggregated")[1]]
        assert json.loads(out) == json.loads(json.dumps(obs.bottleneck_report(rows)))
    if case == "perfetto":
        assert (tmp_path / "repro_torch.json").read_bytes() \
            == (tmp_path / "repro.json").read_bytes()


def test_real_engine_report_equals_the_reference(tmp_path):
    """A real ``TorchRunner`` engine (smoke llama3.2-3b, fp32, on the CPU)
    serving 8 requests on half the pool they need under naive admission, as
    the card's ``capacity`` phase does at full size: its recorded stream, and
    the JSONL file of it, fold to the reference's report of the same stream.
    The spans telescope to each request's measured latency, and the
    preempting run reads ``capacity_bound``."""
    cfg = get_smoke_config("llama3.2-3b")
    requests = make_requests(cfg.vocab, 8, (20, 60), (20, 40), seed=0)
    ecfg = EngineConfig(n_pages=pages_to_hold(requests) // 2, max_num_seqs=8,
                        admission_mode="naive", sanitize=True)
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device="cpu"),
                          virtual_clock=False)
    eng.events.enable_recording()
    reqs = [eng.submit(p, n) for p, n in requests]
    eng.run(max_steps=5000)
    path = tmp_path / "card.jsonl"
    assert dump_events(eng.events.events, str(path)) == len(eng.events.events)
    rep = obs.bottleneck_report(eng.events.events)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert_close(rep, jobs.bottleneck_report(rows))
    assert_close(obs.bottleneck_report(rows), rep)
    spans = {s.rid: s for s in obs.fold_spans(eng.events.events).spans}
    for r in reqs:
        assert spans[r.rid].total_s == r.t_finished - r.arrival
    assert rep["requests"]["n_finished"] == len(requests)
    assert rep["requests"]["n_preempted"] > 0
    assert rep["regimes"]["fractions"]["capacity_bound"] > 0
