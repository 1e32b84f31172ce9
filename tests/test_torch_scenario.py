"""The port's scenario layer (``repro_torch.scenario``: spec, registry,
compile, crosscheck) against ``repro.scenario``. The modules are
framework-free copies compiled onto the port's planner, ``InferenceEngine``,
``SimRunner`` workers and ``ClusterRuntime``, so every registry scenario must
give the reference's JSON bytes, feasibility diagnostics, resolution, ranked
plan estimates and fleet estimate, and, on traces cut to a few requests, the
reference's engine summaries and event streams, sanitized cluster summaries
and crosscheck reports, all exactly. The one departure: ``HARDWARE`` holds
``"h100"``, the port's card, which the reference refuses.
"""
import dataclasses
import enum
import json

import pytest

from repro import scenario as jscenario
from repro_torch import scenario
from repro_torch.core import perf_model as pm

NAMES = list(jscenario.SCENARIOS)
# requests a cut engine or cluster run serves; the autoscaled fleet needs 40
# for its controller to scale up
ENGINE_REQUESTS = 6
CLUSTER_REQUESTS = {"ds8b-4xh200-colocated": 8, "ds8b-4xh200-disagg": 16,
                    "ds8b-4xh200-mixed": 8, "ds8b-autoscale-diurnal": 40}
CROSSCHECK = {"ds8b-4xh200-colocated": 8, "ds8b-4xh200-disagg": 8,
              "ds8b-8xh200-dp8": 4}


def plain(x):
    """Dataclasses, enums and containers as plain data, with each
    dataclass's type name, so two packages' objects compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def cut(mod, name, n):
    sc = mod.get_scenario(name)
    return mod.variant(name, traffic=dataclasses.replace(sc.traffic, n_requests=n))


def test_exports_and_registry_equal_the_reference():
    assert sorted(scenario.__all__) == sorted(jscenario.__all__)
    assert list(scenario.SCENARIOS) == NAMES
    assert set(scenario.HARDWARE) == set(jscenario.HARDWARE) | {"h100"}
    assert scenario.WORKLOADS.keys() == jscenario.WORKLOADS.keys()
    assert (scenario.PROCESSES, scenario.ROLES, scenario.AUTOSCALE_POLICIES) \
        == (jscenario.PROCESSES, jscenario.ROLES, jscenario.AUTOSCALE_POLICIES)


@pytest.mark.parametrize("name", NAMES)
def test_spec_json_and_check_equal_the_reference(name):
    """Same JSON bytes; the port's ``from_json`` round-trips them (and the
    reference's JSON) to an equal spec; the same diagnostics with warnings."""
    sc, ref = scenario.get_scenario(name), jscenario.get_scenario(name)
    assert sc.to_json() == ref.to_json()
    assert scenario.Scenario.from_json(sc.to_json()) == sc
    assert scenario.Scenario.from_json(ref.to_json()) == sc
    assert scenario.Scenario.from_dict(json.loads(sc.to_json())) == sc
    assert sc.check() == []
    assert plain(sc.check(include_warnings=True)) \
        == plain(ref.check(include_warnings=True))


@pytest.mark.parametrize("name", NAMES)
def test_resolve_and_plans_equal_the_reference(name):
    """``resolve`` (model, workload, each group's hardware, pages and
    admission), ``to_plan``'s ranked estimates, ``planner_workload``,
    ``aggregate_plan`` and, for a one-group fleet, ``estimate_fleet``."""
    sc, ref = scenario.get_scenario(name), jscenario.get_scenario(name)
    assert plain(scenario.resolve(sc)) == plain(jscenario.resolve(ref))
    ests = sc.to_plan()
    assert ests and plain(ests) == plain(ref.to_plan())
    assert plain(scenario.planner_workload(sc)) == plain(jscenario.planner_workload(ref))
    assert plain(scenario.trace(sc)) == plain(jscenario.trace(ref))
    if len(sc.fleet) == 1:
        assert plain(scenario.aggregate_plan(sc)) == plain(jscenario.aggregate_plan(ref))
        est = scenario.estimate_fleet(sc)
        assert est.feasible and plain(est) == plain(jscenario.estimate_fleet(ref))


def engine_run(mod, name):
    """``to_engine()`` of the cut scenario serving its trace closed-loop,
    recording its events."""
    sc = cut(mod, name, ENGINE_REQUESTS)
    eng = sc.to_engine()
    eng.events.enable_recording()
    for e in sc.trace():
        eng.submit(e.isl, e.osl, arrival=0.0, slo_class=e.slo_class)
    eng.run(max_steps=2_000_000)
    return eng


@pytest.mark.parametrize("name", NAMES)
def test_to_engine_equals_the_reference(name):
    """The same replica: pool, scheduler config, summary, SLO summary and
    every event."""
    eng, ref = engine_run(scenario, name), engine_run(jscenario, name)
    assert eng.alloc.n_pages == ref.alloc.n_pages
    assert plain(eng.sched.cfg) == plain(ref.sched.cfg)
    s = eng.metrics.summary()
    assert s["n_finished"] == ENGINE_REQUESTS
    assert s == ref.metrics.summary()
    slos = scenario.get_scenario(name).slo_map()
    if slos:
        assert eng.metrics.slo_summary(slos) \
            == ref.metrics.slo_summary(jscenario.get_scenario(name).slo_map())
    assert [e.to_dict() for e in eng.events.events] \
        == [e.to_dict() for e in ref.events.events]


def cluster_run(mod, name):
    sc = cut(mod, name, CLUSTER_REQUESTS[name])
    rt = sc.to_cluster(sanitize=True)
    rt.submit_trace(sc.trace())
    m = rt.run(max_steps=2_000_000)
    summary = m.summary(slos=sc.slo_map()) if len(sc.slos) > 1 \
        else m.summary(slo=sc.slo())
    return rt, m, summary


@pytest.mark.parametrize("name", list(CLUSTER_REQUESTS))
def test_sanitized_cluster_equals_the_reference(name):
    """``to_cluster(sanitize=True)``: the same workers, summary (classes
    for the mixed fleet), request summary, migrations and scaling events;
    the sanitizer raises nowhere."""
    rt, m, s = cluster_run(scenario, name)
    jrt, jm, js = cluster_run(jscenario, name)
    assert [(w.name, w.role, w.engine.alloc.n_pages) for w in rt.workers] \
        == [(w.name, w.role, w.engine.alloc.n_pages) for w in jrt.workers]
    assert s["n_finished"] == CLUSTER_REQUESTS[name]
    assert json.dumps(s, sort_keys=True) == json.dumps(js, sort_keys=True)
    assert json.dumps(m.request_summary(), sort_keys=True) \
        == json.dumps(jm.request_summary(), sort_keys=True)
    assert plain(m.scaling_events) == plain(jm.scaling_events)
    if name == "ds8b-4xh200-disagg":
        assert s["n_migrations"] == CLUSTER_REQUESTS[name]
    if name == "ds8b-autoscale-diurnal":
        assert any(e.kind == "scale_up" for e in m.scaling_events)


@pytest.mark.parametrize("name", list(CROSSCHECK))
def test_crosscheck_equals_the_reference(name):
    """The same ratios and findings (rule, severity, message; the
    reference's bounds); ds8b-8xh200-dp8's cut burst raises findings."""
    rep = scenario.crosscheck(scenario.get_scenario(name), CROSSCHECK[name])
    ref = jscenario.crosscheck(jscenario.get_scenario(name), CROSSCHECK[name])
    assert plain(rep) == plain(ref)
    assert scenario.bounds_for(name) == jscenario.bounds_for(name)
    assert rep.ok == (name != "ds8b-8xh200-dp8")


def h100_scenario(mod):
    return mod.Scenario(
        name="ds8b-2xh100", model=mod.ModelRef("ds-distill-8b"),
        fleet=(mod.WorkerGroup(count=2, hardware="h100", n_pages=2000,
                               max_seqs=32),),
        traffic=mod.Traffic(process="closed", n_requests=8, osl_cap=400, seed=3))


def test_h100_resolves_to_the_ports_card():
    """A ``Scenario`` on ``"h100"`` resolves to ``pm.H100`` and compiles at
    every fidelity; the reference has no such hardware."""
    sc = h100_scenario(scenario)
    assert sc.check() == []
    assert scenario.resolve(sc).groups[0].hardware is pm.H100
    est = scenario.estimate_fleet(sc)
    assert est.feasible and est.kv_capacity_tokens == 2000 * 16
    assert scenario.Scenario.from_json(sc.to_json()) == sc
    eng = sc.to_engine()
    assert eng.runner.hw is pm.H100
    rt = sc.to_cluster(sanitize=True)
    rt.submit_trace(sc.trace())
    assert rt.run().summary()["n_finished"] == 8
    with pytest.raises(KeyError, match="h100"):
        jscenario.resolve(h100_scenario(jscenario))
