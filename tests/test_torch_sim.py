"""The port's sim half against the JAX package's: the perf model, the
planner, ``SimRunner`` behind the engine copy, ``DPRouter`` with the cluster
layer's policies, the reasoning workload, the engine sanitizer and
``serve --sim``. The modules are framework-free copies, so every number,
summary, event stream and printed line must equal the reference's (floats
to 1e-12 relative, where a sum's order could differ; in practice they are
equal). The port adds an H100 hardware model, and the real engine on
``TorchRunner`` takes the same steps and preemptions as ``SimRunner``
behind the same engine config, since the scheduler reads no clock.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.registry import ALL_MODELS as JAX_MODELS
from repro.core import perf_model as jpm
from repro.core import planner as jplanner
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.router import DPRouter as JaxRouter
from repro.core.router import RouterConfig as JaxRouterConfig
from repro.core.runner import SimRunner as JaxSimRunner
from repro.data import reasoning as jreasoning
from repro_torch.configs.registry import ALL_MODELS, get_smoke_config
from repro_torch.core import perf_model as pm
from repro_torch.core import planner
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.router import DPRouter, RouterConfig
from repro_torch.core.runner import SimRunner, TorchRunner
from repro_torch.data import reasoning
from repro_torch.launch.serve import make_requests, pages_to_hold
from repro_torch.lint.sanitizer import SanitizerError
from repro_torch.models.transformer import Transformer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REL = 1e-12
PLANS = [dict(), dict(tp=2, ep=2), dict(tp=8, ep=8), dict(tp=4, pp=2, ep=4),
         dict(dp=2, tp=4, ep=4)]
HW = ["H200", "V5E"]
PAPER = ["ds-distill-8b", "ds-distill-14b", "ds-distill-32b", "ds-distill-70b",
         "deepseek-r1-671b", "llama3-405b"]


def assert_close(mine, ref):
    """Equal structure; numbers within ``REL`` relative."""
    if isinstance(ref, dict):
        assert mine.keys() == ref.keys()
        for k in ref:
            assert_close(mine[k], ref[k])
    elif isinstance(ref, float):
        assert math.isclose(mine, ref, rel_tol=REL, abs_tol=0.0) or mine == ref
    else:
        assert mine == ref


def both(hw_name, plan_kw):
    return ((getattr(pm, hw_name), pm.ParallelismPlan(**plan_kw)),
            (getattr(jpm, hw_name), jpm.ParallelismPlan(**plan_kw)))


def test_hardware_and_constants_equal_the_reference():
    for name in HW:
        assert dataclasses.asdict(getattr(pm, name)) \
            == dataclasses.asdict(getattr(jpm, name))
    # the reference's hardware keep their pass overheads; the H100 takes the
    # GPU value of the H200, whose link terms it shares
    assert {k: v for k, v in pm.PP_PASS_OVERHEAD.items() if k != pm.H100.name} \
        == jpm.PP_PASS_OVERHEAD
    assert pm.MOE_SYNC_ALPHA == jpm.MOE_SYNC_ALPHA
    # the card's published peaks; link terms of H200's NVLink generation
    assert (pm.H100.flops, pm.H100.hbm_bw, pm.H100.hbm_cap) == (989e12, 3.35e12, 80e9)
    assert (pm.H100.link_bw, pm.H100.link_alpha, pm.H100.inter_bw) \
        == (pm.H200.link_bw, pm.H200.link_alpha, pm.H200.inter_bw)
    assert pm.PP_PASS_OVERHEAD[pm.H100.name] == pm.PP_PASS_OVERHEAD[pm.H200.name] == 5e-3


@pytest.mark.parametrize("arch", sorted(ALL_MODELS))
def test_perf_model_equals_the_reference(arch):
    """Every function of the perf model, for every plan and both of the
    reference's hardware models."""
    cfg, jcfg = ALL_MODELS[arch], JAX_MODELS[arch]
    assert pm.weight_bytes(cfg) == jpm.weight_bytes(jcfg)
    assert_close(pm.kv_bytes(cfg, 4096, n_seqs=3), jpm.kv_bytes(jcfg, 4096, n_seqs=3))
    for n in (1, 2, 8, 16):
        assert pm._tp_eff(n) == jpm._tp_eff(n)
    for hw_name in HW:
        for plan_kw in PLANS:
            (hw, plan), (jhw, jplan) = both(hw_name, plan_kw)
            for kind in ("all-reduce", "all-gather", "all-to-all"):
                assert_close(pm._collective_time(1e6, plan.tp, hw, kind),
                             jpm._collective_time(1e6, jplan.tp, jhw, kind))
            assert pm.kv_capacity_tokens(cfg, plan, hw) \
                == jpm.kv_capacity_tokens(jcfg, jplan, jhw)
            for tokens in (1, 512, 8192):
                assert_close(pm.prefill_step_time(cfg, tokens, plan, hw),
                             jpm.prefill_step_time(jcfg, tokens, jplan, jhw))
                assert_close(pm.pp_transport_time(cfg, tokens, plan, hw),
                             jpm.pp_transport_time(jcfg, tokens, jplan, jhw))
                assert_close(pm.kv_transfer_time(cfg, tokens, hw),
                             jpm.kv_transfer_time(jcfg, tokens, jhw))
            for batch, ctx in ((1, 128.0), (16, 1500.0), (256, 7000.5)):
                assert_close(pm.decode_step_time(cfg, batch, ctx, plan, hw),
                             jpm.decode_step_time(jcfg, batch, ctx, jplan, jhw))
                assert_close(pm.pp_bubble_factor(cfg, plan, hw, batch, ctx),
                             jpm.pp_bubble_factor(jcfg, jplan, jhw, batch, ctx))
            assert_close(pm.weight_load_time(cfg, plan, hw),
                         jpm.weight_load_time(jcfg, jplan, jhw))
            assert plan.label() == jplan.label()


def test_h100_holds_kv_for_every_model_that_fits_it_whole():
    """As on V5E, a model whose weights fit one card's HBM beside the
    runtime's share leaves room for KV (or, attention-free, for state)."""
    fits = [a for a, cfg in ALL_MODELS.items()
            if pm.weight_bytes(cfg) < pm.H100.hbm_cap * 0.9]
    assert {"llama3.2-3b", "musicgen-medium", "qwen3-14b", "zamba2-2.7b",
            "xlstm-350m", "ds-distill-32b"} <= set(fits)
    assert "internvl2-76b" not in fits
    for arch in fits:
        assert pm.kv_capacity_tokens(ALL_MODELS[arch], pm.ParallelismPlan(),
                                     pm.H100) > 0, arch


def ranked(ests):
    return [(e.label(), e.feasible, e.reason, e.completion_s,
             e.decode_tput_tok_s, e.concurrency, e.kv_capacity_tokens,
             e.step_parts) for e in ests]


@pytest.mark.parametrize("arch", PAPER)
@pytest.mark.parametrize("hw_name", HW)
def test_planner_ranks_plans_as_the_reference(arch, hw_name):
    mine = planner.plan(ALL_MODELS[arch], getattr(pm, hw_name), 8)
    ref = jplanner.plan(JAX_MODELS[arch], getattr(jpm, hw_name), 8)
    assert len(mine) == len(ref) == len(planner.candidate_plans(8))
    for m, r in zip(ranked(mine), ranked(ref)):
        assert_close(dict(enumerate(m)), dict(enumerate(r)))
    best = planner.best(ALL_MODELS[arch], getattr(pm, hw_name), 8)
    assert best.label() == ref[0].label()


def test_planner_finds_an_h100_plan_for_every_model():
    """As the reference's v5e test: a feasible plan on 256 cards."""
    for arch, cfg in ALL_MODELS.items():
        best = planner.best(cfg, pm.H100, 256)
        assert best.feasible, f"{arch}: no feasible h100 plan"
        assert best.plan.devices == 256


def sim_engines(max_seqs, n_pages, admission="naive", sanitize=False):
    """The same virtual-clock engine from both packages: DS-Distill-8B on
    ``SimRunner`` with H200 constants, as ``tests/test_engine.py`` builds
    it, events recorded."""
    out = []
    for eng_cls, cfg_cls, runner_cls, mod, models in (
            (JaxEngine, JaxEngineConfig, JaxSimRunner, jpm, JAX_MODELS),
            (InferenceEngine, EngineConfig, SimRunner, pm, ALL_MODELS)):
        cfg = models["ds-distill-8b"]
        kw = dict(sanitize=True) if sanitize else {}
        ecfg = cfg_cls(n_pages=n_pages, max_num_seqs=max_seqs,
                       max_num_batched_tokens=4096, chunk_size=256,
                       admission_mode=admission, **kw)
        eng = eng_cls(cfg, ecfg, runner_cls(cfg, mod.ParallelismPlan(), mod.H200))
        eng.events.enable_recording()
        out.append(eng)
    return out


def run_both(engines, work, max_steps=50000):
    runs = []
    for eng in engines:
        for isl, osl in work:
            eng.submit(isl, osl, arrival=0.0)
        eng.run(max_steps=max_steps)
        runs.append((eng.metrics.summary(),
                     [ev.to_dict() for ev in eng.events.events]))
    (s_ref, ev_ref), (s_mine, ev_mine) = runs
    assert s_mine == s_ref
    assert ev_mine == ev_ref
    return s_mine


# the workload of ``tests/test_engine.py``'s sim tests (120 requests of 100
# prompt and 600 output tokens on 3000 pages) at half the output and half
# the pool: the same oversubscription in half the steps
SIM_WORK = [(100, 300)] * 120
SIM_PAGES = 1500


@pytest.mark.parametrize("max_seqs", [16, 256])
def test_sim_capacity_trap_equals_the_reference(max_seqs):
    """The workload of ``test_sim_capacity_trap_dynamics``: the same summary
    and event stream at both concurrency caps."""
    s = run_both(sim_engines(max_seqs, SIM_PAGES), SIM_WORK)
    assert s["n_finished"] == 120
    assert (s["preemptions"] > 0) == (max_seqs == 256)


def test_sim_kv_aware_admission_equals_the_reference():
    naive = run_both(sim_engines(256, SIM_PAGES, "naive"), SIM_WORK)
    aware = run_both(sim_engines(256, SIM_PAGES, "kv_aware"), SIM_WORK)
    assert naive["preemptions"] > 0
    assert aware["preemptions"] == 0 and aware["recomputed_tokens"] == 0


def test_sanitized_sim_resumes_without_inflated_context_as_the_reference():
    """``test_resumed_request_context_len_not_inflated`` with the sanitizer
    on both engines (``sanitize=True``): it checks every step, and a
    resumed request's context is its prompt and output alone."""
    engines = sim_engines(256, SIM_PAGES, "naive", sanitize=True)
    s = run_both(engines, SIM_WORK)
    assert s["preemptions"] > 0
    for r in engines[1].metrics.finished:
        assert r.resume_extra == 0
        assert r.context_len == r.isl + r.generated


def test_sanitizer_leaves_the_sim_summary_bit_identical():
    plain, = sim_engines(256, 3000)[1:]
    checked, = sim_engines(256, 3000, sanitize=True)[1:]
    assert checked._sanitizer is not None and plain._sanitizer is None
    for eng in (plain, checked):
        for isl, osl in [(512, 64)] * 10 + [(100, 600)] * 40:
            eng.submit(isl, osl)
        eng.run()
    assert json.dumps(plain.metrics.summary(), sort_keys=True) \
        == json.dumps(checked.metrics.summary(), sort_keys=True)


def test_sanitizer_catches_a_leaked_page():
    eng, = sim_engines(256, 3000, sanitize=True)[1:]
    eng.submit(256, 32)
    assert eng.step()
    eng.alloc._free.pop()            # a page leaves the pool unaccounted
    with pytest.raises(SanitizerError, match="KV page leak"):
        eng.step()


def test_memory_aware_router_equals_the_reference():
    """``test_memory_aware_router_balances``: 160 requests over 4 replicas;
    the same placement, per-replica summaries and event streams."""
    summaries = []
    for router_cls, rcfg_cls, idx in ((JaxRouter, JaxRouterConfig, 0),
                                      (DPRouter, RouterConfig, 1)):
        replicas = [sim_engines(64, 2000)[idx] for _ in range(4)]
        router = router_cls(replicas, rcfg_cls(policy="memory_aware"))
        for _ in range(160):
            router.submit(100, 400, arrival=0.0)
        counts = [len(e.sched.waiting) + len(e.sched.running) for e in replicas]
        assert max(counts) - min(counts) <= 2, counts
        router.run_all()
        summaries.append(([e.metrics.summary() for e in replicas], counts,
                          [[ev.to_dict() for ev in e.events.events]
                           for e in replicas]))
    assert summaries[1] == summaries[0]
    assert sum(s["n_finished"] for s in summaries[1][0]) == 160


@pytest.mark.parametrize("policy", ["round_robin", "jsq"])
def test_other_routing_policies_equal_the_reference(policy):
    placements = []
    for router_cls, rcfg_cls, idx in ((JaxRouter, JaxRouterConfig, 0),
                                      (DPRouter, RouterConfig, 1)):
        replicas = [sim_engines(32, 600)[idx] for _ in range(3)]
        router = router_cls(replicas, rcfg_cls(policy=policy))
        rng = np.random.default_rng(7)
        for _ in range(60):
            router.submit(int(rng.integers(50, 400)), int(rng.integers(20, 300)),
                          arrival=0.0)
        router.run_all()
        placements.append([e.metrics.summary() for e in replicas])
    assert placements[1] == placements[0]


@pytest.mark.parametrize("spec", ["REASONING", "CHAT", "LONG_REASONING"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reasoning_workload_equals_the_reference(spec, seed):
    mine, ref = getattr(reasoning, spec), getattr(jreasoning, spec)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert reasoning.sample(mine, 500, seed) == jreasoning.sample(ref, 500, seed)
    assert reasoning.profile(mine, 2000, seed) == jreasoning.profile(ref, 2000, seed)


@pytest.mark.parametrize("admission", ["naive", "kv_aware"])
def test_real_engine_takes_the_sim_engines_steps_and_preemptions(admission):
    """The rehearsal of ``chip_smoke.py``'s ``capacity`` phase at smoke
    size: the same requests on half the pool that holds them, served by
    ``TorchRunner`` (CPU, fp32, sanitizer on) and by ``SimRunner`` (H100
    constants) behind the same ``EngineConfig``. All arrive at t=0, and the
    scheduler reads no clock, so both take the same steps and preempt the
    same requests; naive admission preempts, kv-aware never does."""
    cfg = get_smoke_config("llama3.2-3b")
    requests = make_requests(cfg.vocab, 8, (20, 60), (20, 40), seed=0)
    ecfg = EngineConfig(n_pages=pages_to_hold(requests) // 2, max_num_seqs=8,
                        admission_mode=admission, sanitize=True)
    model = Transformer(cfg, device="cpu", dtype=torch.float32, seed=0)
    runs = []
    for runner, virtual in ((TorchRunner(model, device="cpu"), False),
                            (SimRunner(cfg, pm.ParallelismPlan(), pm.H100), True)):
        eng = InferenceEngine(cfg, ecfg, runner, virtual_clock=virtual)
        eng.events.enable_recording()
        reqs = [eng.submit(p if not virtual else len(p), n) for p, n in requests]
        eng.run(max_steps=5000)
        assert [len(r.output) for r in reqs] == [n for _, n in requests]
        s = eng.metrics.summary()
        runs.append(dict(steps=len(eng.metrics.timeline),
                         preemptions=s["preemptions"],
                         recomputed=s["recomputed_tokens"],
                         per_request=[r.n_preemptions for r in reqs],
                         events=[(ev.kind, ev.rid) for ev in eng.events.events]))
    assert runs[0] == runs[1]
    assert (runs[0]["preemptions"] > 0) == (admission == "naive")


def run_serve_sim(package, *args):
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-m", f"{package}.launch.serve", "--sim", *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_serve_sim_prints_the_reference_lines():
    args = ("--arch", "ds-distill-8b", "--hw", "h200", "--requests", "40")
    mine = run_serve_sim("repro_torch", *args)
    assert mine == run_serve_sim("repro", *args)
    assert mine.startswith("[replica 0] done=40 ")


def test_serve_sim_runs_on_the_h100_model():
    out = run_serve_sim("repro_torch", "--arch", "llama3.2-3b", "--hw", "h100",
                        "--dp", "2", "--requests", "12")
    lines = out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["[replica", "[replica", "[fleet]"]
    assert sum(int(ln.split("done=")[1].split()[0]) for ln in lines[:2]) == 12
