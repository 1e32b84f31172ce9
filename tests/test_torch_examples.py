"""The port's four examples (``repro_torch.examples``: quickstart,
serve_reasoning, plan_deployment, serve_cluster) against the reference's
``examples/*.py``, on the CPU.

- quickstart ``--smoke --device cpu``: the engine's and the planner's lines
  equal the reference's; the forward line has its shape and finite logits.
- serve_reasoning's real half, both admissions, on the reduced model in
  fp32: finished requests, tokens, preemptions and recomputed tokens equal
  the reference example's, and with the reference's ``PRNGKey(0)`` weights
  carried across by ``models.bridge.from_jax_params`` every greedy token
  equals its engine's. Its sim half, cut to 16 requests, equals the same
  engine built from ``repro`` (the summary, exactly).
- plan_deployment and serve_cluster print the reference scripts' stdout
  (each pair run as subprocesses, all at once, from the module's first
  test on; the package's name masked).
"""
import importlib.util
import io
import json
import os
import runpy
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import pytest

from repro.configs.paper_models import DS_DISTILL_8B as J_DS8B
from repro.configs.registry import get_smoke_config as j_smoke_config
from repro.core import perf_model as jpm
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import InferenceEngine as JEngine
from repro.core.runner import SimRunner as JSimRunner
from repro.data.reasoning import REASONING as J_REASONING, sample as j_sample
from repro.models import transformer as JT
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs.registry import get_smoke_config
from repro_torch.examples import quickstart, serve_reasoning
from repro_torch.models.bridge import from_jax_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
SUMMARY_FIELDS = ("n_finished", "gen_tokens", "preemptions", "recomputed_tokens")
SIM_REQUESTS = 16
SCRIPTS = {
    "plan_scenario": ["--scenario", "ds8b-4xh200-colocated"],
    "plan_classic": ["--arch", "kimi-k2-1t-a32b", "--hw", "v5e", "--devices", "256"],
    "cluster": [],
}


def ref_example(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start(package, script, args):
    """``script`` of the reference (``examples/``) or of the port
    (``python -m repro_torch.examples.``), started in the background."""
    module = "plan_deployment" if script.startswith("plan") else "serve_cluster"
    cmd = [sys.executable, os.path.join(ROOT, "examples", f"{module}.py")] \
        if package == "repro" else \
        [sys.executable, "-m", f"repro_torch.examples.{module}"]
    return subprocess.Popen(cmd + args, cwd=ROOT, text=True,
                            env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module", autouse=True)
def scripts():
    """Every script pair, started at once when the module's first test
    starts; each test reads its pair. None is left running."""
    procs = {(script, package): start(package, script, args)
             for script, args in SCRIPTS.items() for package in ("repro", "repro_torch")}
    procs[("plan_h100", "repro_torch")] = start(
        "repro_torch", "plan_h100", ["--arch", "ds-distill-8b", "--hw", "h100",
                                     "--devices", "8"])
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


def finished(proc, package):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out.replace(package + ".", "PKG."), err


def test_quickstart_smoke_lines_equal_the_reference():
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"),
                       run_name="__main__")
    ref = buf.getvalue().splitlines()
    buf = io.StringIO()
    with redirect_stdout(buf):
        quickstart.main(["--smoke", "--device", "cpu"])
    mine = buf.getvalue().splitlines()
    assert len(mine) == len(ref) == 3
    assert mine[0] == ref[0] == "[1] forward: logits (1, 16, 256), finite=True"
    assert mine[1:] == ref[1:]
    assert mine[1] == "[2] engine: 5 requests, 40 tokens, preemptions=0"


def test_quickstart_asks_for_the_card_by_default():
    """A card is asked for by default and never replaced by the CPU. (On
    the card, ``--smoke`` raises the kernels' head-dim error: the reduced
    model's head dim is 16; ``chip_smoke.py`` checks it there.)"""
    assert get_smoke_config("llama3.2-3b").head_dim == 16
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main(["--smoke"])


def outputs(eng):
    return [r.output for r in sorted(eng.metrics.finished, key=lambda r: r.rid)]


@pytest.mark.parametrize("admission", ["naive", "kv_aware"])
def test_real_engine_run_equals_the_reference(admission, monkeypatch):
    """The real half on the reduced model: the port's seeded run gives the
    reference example's deterministic summary fields (10 requests, 468
    tokens, no preemption), and the reference's own weights give its
    greedy tokens."""
    ref_mod = ref_example("serve_reasoning")
    made = []

    class Recorded(JEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(ref_mod, "InferenceEngine", Recorded)
    ref = ref_mod.real_engine_run(admission)
    mine = serve_reasoning.real_engine_run(
        admission, quickstart.build_model(smoke=True, device="cpu"))
    assert {k: mine[k] for k in SUMMARY_FIELDS} == {k: ref[k] for k in SUMMARY_FIELDS}
    assert (mine["n_finished"], mine["gen_tokens"], mine["preemptions"]) == (10, 468, 0)

    jcfg = j_smoke_config("llama3.2-3b")
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), single_device_ctx(),
                            mode="serve", dtype=jnp.float32)
    model = from_jax_params(params, get_smoke_config("llama3.2-3b"), device="cpu")
    eng = serve_reasoning.real_engine(admission, model)
    assert outputs(eng) == outputs(made[0])
    assert eng.metrics.summary()["gen_tokens"] == 468


def ref_sim_fleet_run(admission, n_requests):
    """The reference example's ``sim_fleet_run`` at ``n_requests``."""
    cfg = J_DS8B
    eng = JEngine(
        cfg,
        JEngineConfig(n_pages=jpm.kv_capacity_tokens(
            cfg, jpm.ParallelismPlan(), jpm.H200) // 16,
            max_num_seqs=384, max_num_batched_tokens=8192,
            chunk_size=512, admission_mode=admission),
        JSimRunner(cfg, jpm.ParallelismPlan(), jpm.H200))
    cap = eng.alloc.n_pages * 16
    for isl, osl in j_sample(J_REASONING, n_requests, seed=0):
        eng.submit(int(isl), int(min(osl, 8000, cap - isl - 2)), arrival=0.0)
    return eng.run(max_steps=300_000).summary()


@pytest.mark.parametrize("admission", ["naive", "kv_aware"])
def test_sim_fleet_run_equals_the_reference(admission):
    mine = serve_reasoning.sim_fleet_run(admission, n_requests=SIM_REQUESTS)
    assert mine["n_finished"] == SIM_REQUESTS
    assert json.dumps(mine, sort_keys=True) \
        == json.dumps(ref_sim_fleet_run(admission, SIM_REQUESTS), sort_keys=True)


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_script_stdout_equals_the_reference(script, scripts):
    """plan_deployment (a scenario's three fidelities; classic ranking) and
    serve_cluster print the reference scripts' lines and exit 0."""
    mine = finished(scripts[(script, "repro_torch")], "repro_torch")
    ref = finished(scripts[(script, "repro")], "repro")
    assert mine[0] == ref[0] == 0, (mine[2][-2000:], ref[2][-2000:])
    assert mine[1] == ref[1]
    assert len(mine[1].splitlines()) > 5


def test_plan_deployment_ranks_plans_on_h100(scripts):
    """``--hw h100``, the one choice the reference lacks: the port's card
    in the classic ranking."""
    rc, out, err = finished(scripts[("plan_h100", "repro_torch")], "repro_torch")
    assert rc == 0, err[-2000:]
    assert out.splitlines()[0].startswith("ds-distill-8b on 8x h100-sxm")
    assert "DP=8" in out
