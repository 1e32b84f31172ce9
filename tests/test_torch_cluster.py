"""The port's cluster layer (``repro_torch.cluster``: arrivals, metrics,
rebalance, autoscale, runtime) and its ``ClusterSanitizer`` against
``repro.cluster`` and ``repro.lint.sanitizer``. The modules are
framework-free copies, so the same trace served by the same fleet must give
the reference's summary, request summary, migration and scaling records and
fleet event stream (floats to 1e-12 relative, where a sum's order could
differ; in practice they are equal). Fleets are DS-Distill-8B
``make_sim_worker`` replicas on H200 constants, as ``tests/test_cluster.py``
builds them, at 30-60 requests. Also here: the port's H100 pipeline-pass
price, the one place its perf model departs from the reference's.
"""
import dataclasses
import json
import math
import types

import pytest
import torch

from repro import cluster as jcluster
from repro.configs.paper_models import DS_DISTILL_8B as J_DS8B
from repro.core import perf_model as jpm
from repro.core.metrics import SLO as JSLO
from repro.core.request import Request as JRequest
from repro.core.runner import SimRunner as JSimRunner
from repro.data import reasoning as jreasoning
from repro.lint import sanitizer as jsanitizer
from repro_torch import cluster
from repro_torch.configs.paper_models import DS_DISTILL_8B
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import perf_model as pm
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.metrics import SLO
from repro_torch.core.request import Request
from repro_torch.core.runner import SimRunner, TorchRunner
from repro_torch.data import reasoning
from repro_torch.lint import sanitizer
from repro_torch.models.transformer import Transformer

REL = 1e-12
REF = types.SimpleNamespace(cl=jcluster, pm=jpm, cfg=J_DS8B, data=jreasoning,
                            SLO=JSLO, san=jsanitizer, Request=JRequest,
                            SimRunner=JSimRunner)
PORT = types.SimpleNamespace(cl=cluster, pm=pm, cfg=DS_DISTILL_8B, data=reasoning,
                             SLO=SLO, san=sanitizer, Request=Request,
                             SimRunner=SimRunner)
# two tiers, the interactive one urgent, as the reference's scenarios tag them
CLASS_MIX = (("interactive", 0.3), ("batch", 0.7))
PRIORITIES = {"interactive": 10, "batch": 0}


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


def slos(ns):
    return {"interactive": ns.SLO(ttft_s=0.5, tpot_s=0.02),
            "batch": ns.SLO(ttft_s=30.0, tpot_s=0.5)}


def worker(ns, name, role="colocated", n_pages=3000, max_seqs=64, **kw):
    return ns.cl.make_sim_worker(ns.cfg, ns.pm.ParallelismPlan(), ns.pm.H200,
                                 role=role, name=name, n_pages=n_pages,
                                 max_seqs=max_seqs, **kw)


def fleet(ns, mode, n_pages=3000, **kw):
    """Four replicas: colocated, or 2 prefill + 2 decode."""
    if mode == "colocated":
        return [worker(ns, f"co{i}", n_pages=n_pages, **kw) for i in range(4)]
    return [worker(ns, f"{role[:3]}{i}", role, n_pages, **kw)
            for role in ("prefill", "decode") for i in range(2)]


def process(ns, name):
    if name == "poisson":
        return ns.cl.PoissonProcess(rate=20.0)
    if name == "gamma":
        return ns.cl.GammaProcess(rate=20.0, cv=2.0)
    return ns.cl.PiecewiseRateProcess(phases=((1.0, 4.0), (1.0, 40.0), (2.0, 8.0)),
                                      repeat=False)


def trace(ns, proc="poisson", n=30, seed=3, osl_cap=300, classes=True):
    tr = ns.cl.make_trace(process(ns, proc), ns.data.REASONING, n, seed=seed,
                          osl_cap=osl_cap)
    return ns.cl.assign_classes(tr, CLASS_MIX, seed=seed) if classes else tr


def serve(rt, tr, ns):
    rt.events.enable_recording()
    rt.submit_trace(tr)
    m = rt.run()
    return dict(summary=m.summary(slos=slos(ns)), requests=m.request_summary(),
                migrations=[dataclasses.asdict(r) for r in m.migrations],
                scaling=[dataclasses.asdict(e) for e in m.scaling_events],
                events=[e.to_dict() for e in rt.events.events])


def both(run):
    """``run(ns)`` on the reference, then on the port; the port's result."""
    ref, mine = run(REF), run(PORT)
    assert_close(mine, ref)
    return mine


def test_exports_equal_the_reference():
    assert cluster.__all__ == jcluster.__all__
    assert [f.name for f in dataclasses.fields(cluster.ClusterConfig)] \
        == [f.name for f in dataclasses.fields(jcluster.ClusterConfig)]


@pytest.mark.parametrize("proc", ["poisson", "gamma", "piecewise", "piecewise_repeat",
                                  "trace"])
def test_arrival_times_equal_the_reference_draw_for_draw(proc):
    def times(ns):
        if proc == "piecewise_repeat":
            p = ns.cl.PiecewiseRateProcess(phases=((2.0, 5.0), (1.0, 0.0), (1.0, 30.0)))
        elif proc == "trace":
            p = ns.cl.TraceProcess(arrivals=[0.3, 0.1, 0.2, 0.7, 0.5])
        else:
            p = process(ns, proc)
        n = 5 if proc == "trace" else 400
        return [p.times(n, seed=s, t0=t0) for s, t0 in ((0, 0.0), (7, 2.5))]
    ts = both(times)
    assert all(b >= a for a, b in zip(ts[0], ts[0][1:]))


def test_traces_and_classes_equal_the_reference():
    def make(ns):
        tr = trace(ns, "gamma", n=200, seed=11, osl_cap=500)
        return [dataclasses.asdict(e) for e in tr]
    rows = both(make)
    assert {r["slo_class"] for r in rows} == {"interactive", "batch"}


def test_save_and_load_trace_round_trip_to_the_reference_bytes(tmp_path):
    def save(ns):
        tr = trace(ns, "piecewise", n=60, seed=4)
        path = tmp_path / f"{ns.cl.__name__}.jsonl"
        ns.cl.save_trace(str(path), tr)
        return tr, path
    (jtr, jpath), (tr, path) = save(REF), save(PORT)
    assert path.read_bytes() == jpath.read_bytes()
    assert cluster.load_trace(str(path)) == tr
    # each package reads the other's file to the same entries
    assert [dataclasses.asdict(e) for e in cluster.load_trace(str(jpath))] \
        == [dataclasses.asdict(e) for e in jcluster.load_trace(str(path))] \
        == [dataclasses.asdict(e) for e in jtr]


@pytest.mark.parametrize("mode,policy,proc", [
    ("colocated", "RoundRobin", "poisson"),
    ("colocated", "JoinShortestQueue", "gamma"),
    ("colocated", "MemoryAware", "piecewise"),
    ("disaggregated", "LeastKVHeadroom", "poisson"),
    ("disaggregated", "MostKVHeadroom", "piecewise"),
])
def test_cluster_run_equals_the_reference(mode, policy, proc):
    """Summary with a per-class SLO map, request summary, migration records
    and the fleet event stream, under each routing/dispatch policy object."""
    def run(ns):
        pol = getattr(ns.cl, policy)()
        cfg = ns.cl.ClusterConfig(class_priorities=PRIORITIES,
                                  **({"dispatcher": pol} if mode == "disaggregated"
                                     else {"policy": pol}))
        rt = ns.cl.ClusterRuntime(fleet(ns, mode, class_priorities=PRIORITIES), cfg)
        return serve(rt, trace(ns, proc), ns)
    out = both(run)
    assert out["summary"]["n_finished"] == 30
    assert set(out["summary"]["classes"]) == {"interactive", "batch"}
    assert (out["summary"]["n_migrations"] > 0) == (mode == "disaggregated")


def test_kv_pressure_rebalancer_migrates_as_the_reference():
    """Decode workers short of pages: the rebalancer ships decodes between
    them; its decisions, migration records and summary are the reference's."""
    def run(ns):
        ws = [worker(ns, "pre0", "prefill")] \
            + [worker(ns, f"dec{i}", "decode", n_pages=400) for i in range(3)]
        rt = ns.cl.ClusterRuntime(ws, ns.cl.ClusterConfig(
            rebalance=ns.cl.KVPressureRebalancer()))
        return serve(rt, trace(ns, "poisson", seed=42, osl_cap=400,
                               classes=False), ns)
    out = both(run)
    rebalances = [e for e in out["events"] if e["kind"] == "rebalance"]
    assert rebalances
    decode_moves = [m for m in out["migrations"] if m["src"].startswith("dec")]
    assert len(decode_moves) == len(rebalances)


@pytest.mark.parametrize("policy", ["TargetUtilization", "SLOGuard"])
def test_autoscaler_scaling_events_equal_the_reference(policy):
    """A piecewise surge against an elastic colocated pool: both controllers
    retire a replica in the quiet lead-in, then mint into the surge."""
    pages = {"TargetUtilization": 300, "SLOGuard": 3000}[policy]
    n = {"TargetUtilization": 50, "SLOGuard": 60}[policy]

    def run(ns):
        seq = iter(range(2, 100))
        pol = ns.cl.TargetUtilization() if policy == "TargetUtilization" \
            else ns.cl.SLOGuard(attain_floor=0.9)
        ctl = ns.cl.AutoscaleController(
            pol, lambda: worker(ns, f"el{next(seq)}", n_pages=pages),
            role="colocated", min_workers=1, max_workers=4, tick_s=1.0,
            cooldown_s=2.0, slo=ns.SLO(ttft_s=0.5, tpot_s=0.02))
        rt = ns.cl.ClusterRuntime([worker(ns, f"el{i}", n_pages=pages)
                                   for i in range(2)],
                                  ns.cl.ClusterConfig(), autoscaler=ctl)
        proc = ns.cl.PiecewiseRateProcess(
            phases=((6.0, 0.5), (6.0, 20.0 if pages == 300 else 10.0), (12.0, 0.3)),
            repeat=False)
        tr = ns.cl.make_trace(proc, ns.data.REASONING, n, seed=5, osl_cap=200)
        out = serve(rt, tr, ns)
        out["controller"] = (ctl.n_scale_ups, ctl.n_scale_downs)
        return out
    out = both(run)
    kinds = [e["kind"] for e in out["scaling"]]
    assert {"retire", "drained", "scale_up", "join"} <= set(kinds)
    assert out["summary"]["n_finished"] == n


@pytest.mark.parametrize("mode", ["colocated", "disaggregated"])
def test_cluster_sanitizer_leaves_the_summary_bit_identical(mode):
    def run(ns, sanitize):
        rt = ns.cl.ClusterRuntime(fleet(ns, mode), ns.cl.ClusterConfig(),
                                  sanitize=sanitize)
        out = serve(rt, trace(ns, "gamma", n=25, classes=False), ns)
        return json.dumps(out["summary"], sort_keys=True), out["events"]
    plain, checked = run(PORT, False), run(PORT, True)
    assert checked == plain
    assert checked == run(REF, True)


FAULTS = {
    # active before minted
    "lifecycle": (lambda rt: (setattr(rt.workers[0], "t_join", 10.0),
                              setattr(rt.workers[0], "t_active", 0.0)),
                  "before joining"),
    # a decode replica routed new work as if it were a prefill one
    "pool": (lambda rt: rt.prefill_pool.append(rt.decode_pool[0]),
             "sits in the prefill pool"),
    # a worker's engine leaks a page
    "kv_leak": (lambda rt: rt.workers[2].engine.alloc._free.pop(), "KV page leak"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cluster_sanitizer_raises_on_a_seeded_fault_as_the_reference(fault):
    seed_fault, names = FAULTS[fault]

    def run(ns):
        rt = ns.cl.ClusterRuntime(fleet(ns, "disaggregated", n_pages=500),
                                  ns.cl.ClusterConfig(), sanitize=True)
        rt.submit(256, 32, arrival=0.0)
        seed_fault(rt)
        with pytest.raises(ns.san.SanitizerError) as err:
            rt.run()
        return str(err.value)
    assert names in both(run)


def test_cluster_sanitizer_direct_check_passes_on_a_drained_fleet():
    rt = cluster.ClusterRuntime(fleet(PORT, "disaggregated"), cluster.ClusterConfig())
    for isl, osl in [(512, 64)] * 6:
        rt.submit(isl, osl, arrival=0.0)
    rt.run()
    sanitizer.ClusterSanitizer().check(rt)
    for w in rt.workers:
        sanitizer.EngineSanitizer(w.engine).check()


def test_real_clock_worker_is_refused_with_the_reference_message():
    """The runtime co-simulates virtual clocks only. The port's refusal of a
    ``TorchRunner`` worker reads as the reference's of a real-clock one."""
    cfg = get_smoke_config("llama3.2-3b")
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    eng = InferenceEngine(cfg, EngineConfig(n_pages=16, max_num_seqs=2),
                          TorchRunner(model, device="cpu"), virtual_clock=False)
    with pytest.raises(ValueError) as mine:
        cluster.ClusterRuntime([cluster.Worker(engine=eng, name="card")])
    jw = worker(REF, "card")
    jw.engine.virtual_clock = False
    with pytest.raises(ValueError) as ref:
        jcluster.ClusterRuntime([jw])
    assert str(mine.value) == str(ref.value)
    assert "virtual-clock" in str(mine.value)


@pytest.mark.parametrize("hw_name", ["H200", "V5E"])
def test_pp2_sim_runner_equals_the_reference(hw_name):
    """A pipeline-parallel ``SimRunner`` step on the reference's hardware."""
    def step(ns):
        runner = ns.SimRunner(ns.cfg, ns.pm.ParallelismPlan(tp=2, pp=2),
                              getattr(ns.pm, hw_name))
        reqs = [ns.Request(rid=i, prompt=[0] * (300 + 50 * i), max_new_tokens=64)
                for i in range(6)]
        return [runner.iteration_time(p, reqs[:k]) for p, k in
                ((0, 1), (0, 6), (512, 6), (1024, 0))]
    both(step)


def test_h100_prices_a_pipeline_pass_at_the_gpu_value(monkeypatch):
    """At pp 2 a decode round of 6 sequences runs 2 micro-batches, each
    paying one pass: the H100's memory term holds 2 x 5e-3 s of pass
    overhead, the H200's price and not the v5e fallback of 2e-3 s."""
    runner = SimRunner(DS_DISTILL_8B, pm.ParallelismPlan(tp=2, pp=2), pm.H100)
    reqs = [Request(rid=i, prompt=[0] * (300 + 50 * i), max_new_tokens=64)
            for i in range(6)]
    priced = runner.iteration_time(0, reqs)[1]["memory"]
    monkeypatch.setitem(pm.PP_PASS_OVERHEAD, pm.H100.name, 0.0)
    free = runner.iteration_time(0, reqs)[1]["memory"]
    assert math.isclose((priced - free) / 2, 5e-3, rel_tol=1e-9)
