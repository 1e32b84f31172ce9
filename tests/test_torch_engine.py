"""The port's engine and ``TorchRunner`` against the JAX package.

Greedy tokens of the engine on the paged path equal the JAX straight-line
greedy decode on bridged weights, with and without forced preemption (the
two cases of ``tests/test_engine.py``), for the smoke configs of each
served family: llama3.2-3b, DeepSeek-R1 (MLA + MoE), phi3.5-moe, the R1
Llama distill, qwen3-14b (qk-norm), h2o-danube-3-4b (sliding window 16;
its prompts are longer than the window), kimi-k2 (GQA + MoE),
llama3-405b, internvl2-76b (vlm backbone), musicgen-medium (audio, MHA),
zamba2-2.7b (Mamba2 + shared attention) and xlstm-350m
(mLSTM + sLSTM, no attention); the recurrent families keep their state in
the runner's slots, and a preempted request gives its slot back and
recomputes its state when it resumes. Their MoE capacity factor is 8, so
no assignment drops and a batched decode equals each request's own. Under the virtual clock the port's
engine copy and the JAX engine make identical schedules. The port imports
neither JAX nor the JAX package, and never runs on the CPU unasked.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.runner import JaxRunner
from repro.models import transformer as T
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.runner import TorchRunner
from repro_torch.launch.serve import make_requests, serve
from repro_torch.models.bridge import from_jax_params
from repro_torch.models.transformer import Transformer

CTX = single_device_ctx()
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["llama3.2-3b", "deepseek-r1-671b", "phi3.5-moe-42b-a6.6b",
         "ds-distill-8b", "qwen3-14b", "h2o-danube-3-4b", "kimi-k2-1t-a32b",
         "llama3-405b", "internvl2-76b", "musicgen-medium", "zamba2-2.7b",
         "xlstm-350m"]


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg = jax_smoke_config(request.param)
    params = T.init_params(jcfg, jax.random.PRNGKey(0), CTX, mode="serve",
                           dtype=jnp.float32)
    cfg = get_smoke_config(request.param)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg,
                            device="cpu")
    prefill = jax.jit(lambda p, t: T.prefill(p, t, jcfg, CTX, max_len=192,
                                             cache_dtype=jnp.float32))
    decode = jax.jit(lambda p, st, t: T.decode_step(p, st, t, jcfg, CTX))

    def greedy(prompt, n_new):
        last, state = prefill(params, jnp.asarray([prompt], jnp.int32))
        out = [int(jnp.argmax(last[0]))]
        for _ in range(n_new - 1):
            logits, state = decode(params, state,
                                   jnp.asarray([[out[-1]]], jnp.int32))
            out.append(int(jnp.argmax(logits[0, -1])))
        return out

    def jax_engine(prompts, n_new, n_pages, max_num_seqs):
        """Outputs of the JAX engine on ``JaxRunner`` (its slots are
        ``max_num_seqs``), configured as ``_run_engine``."""
        runner = JaxRunner(jcfg, params, CTX, max_slots=max_num_seqs,
                           max_len=192)
        ecfg = JaxEngineConfig(n_pages=n_pages, max_num_seqs=max_num_seqs,
                               max_num_batched_tokens=512, chunk_size=192,
                               admission_mode="naive")
        eng = JaxEngine(jcfg, ecfg, runner, virtual_clock=False)
        reqs = [eng.submit(p, n) for p, n in zip(prompts, n_new)]
        eng.run(max_steps=2000)
        return [r.output for r in reqs], sum(r.n_preemptions for r in reqs)

    return cfg, model, greedy, jax_engine


def _run_engine(cfg, model, prompts, n_new, n_pages, max_num_seqs=4):
    ecfg = EngineConfig(n_pages=n_pages, max_num_seqs=max_num_seqs,
                        max_num_batched_tokens=512, chunk_size=192,
                        admission_mode="naive")
    eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device="cpu"),
                          virtual_clock=False)
    reqs = [eng.submit(p, n) for p, n in zip(prompts, n_new)]
    eng.run(max_steps=2000)
    return reqs


def test_engine_matches_greedy(bridged):
    cfg, model, greedy, _ = bridged
    rng = np.random.default_rng(0)
    extra = cfg.swa_window if cfg.attention == "swa" else 0
    prompts = [rng.integers(0, cfg.vocab, size=n + extra).tolist()
               for n in (7, 11, 5)]
    n_new = [6, 4, 8]
    reqs = _run_engine(cfg, model, prompts, n_new, n_pages=64)
    for p, n, r in zip(prompts, n_new, reqs):
        assert r.output == greedy(p, n)


def test_engine_preemption_preserves_outputs(bridged):
    """A pool of 7 pages forces preemption and recompute; freed pages are
    reused by other requests at once, so a stale pool entry read through a
    new table would change the tokens; a recurrent model's slots are
    reused the same way.

    xLSTM's reference is the JAX engine on ``JaxRunner`` under the same
    preemptions, not straight-line greedy: the JAX package's mLSTM decode
    step returns the stabiliser m it was given while its prefill returns
    the updated one, so a request resumed by recompute leaves the
    straight-line tokens there too. Its runners have 5 slots, a count
    ``JaxRunner`` can tell from every dim of the xLSTM state."""
    cfg, model, greedy, jax_engine = bridged
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=30).tolist() for _ in range(3)]
    n_new = [20, 20, 20]
    seqs = 5 if cfg.family == "ssm" else 4
    reqs = _run_engine(cfg, model, prompts, n_new, n_pages=7, max_num_seqs=seqs)
    preempted = sum(r.n_preemptions for r in reqs)
    assert preempted > 0, "pool was sized to force preemption"
    if cfg.family == "ssm":
        ref, ref_preempted = jax_engine(prompts, n_new, 7, seqs)
        assert ref_preempted == preempted
        assert [r.output for r in reqs] == ref
        return
    for p, n, r in zip(prompts, n_new, reqs):
        assert r.output == greedy(p, n)


class StubRunner:
    """Virtual-clock runner whose step time depends on the batch, so the
    schedule (and with it every timestamp) depends on the engine's
    decisions."""

    def iteration_time(self, prefill_tokens, decode_reqs):
        ctx = sum(r.context_len for r in decode_reqs)
        t = 2e-3 + 1e-5 * prefill_tokens + 3e-4 * len(decode_reqs) + 1e-7 * ctx
        return t, {"memory": 0.5 * t}

    def hbm_busy_fraction(self, parts, t):
        return parts["memory"] / t if t else 0.0


@pytest.mark.parametrize("admission", ["naive", "kv_aware"])
def test_engine_copy_schedules_like_jax_engine(admission):
    """120 requests on an oversubscribed pool: the same summary and the same
    recorded event stream from both engines."""
    rng = np.random.default_rng(5)
    work = [(int(rng.integers(20, 200)), int(rng.integers(50, 400)))
            for _ in range(120)]
    runs = []
    for engine_cls, cfg_cls, mcfg in (
            (JaxEngine, JaxEngineConfig, jax_smoke_config("llama3.2-3b")),
            (InferenceEngine, EngineConfig, get_smoke_config("llama3.2-3b"))):
        ecfg = cfg_cls(n_pages=800, max_num_seqs=64,
                       max_num_batched_tokens=1024, chunk_size=256,
                       admission_mode=admission)
        eng = engine_cls(mcfg, ecfg, StubRunner())
        eng.events.enable_recording()
        for isl, osl in work:
            eng.submit(isl, osl, arrival=0.0)
        eng.run(max_steps=100000)
        runs.append((eng.metrics.summary(),
                     [ev.to_dict() for ev in eng.events.events]))
    (s_jax, ev_jax), (s_port, ev_port) = runs
    assert s_jax["n_finished"] == 120
    if admission == "naive":
        assert s_jax["preemptions"] > 0, "pool was sized to force preemption"
    assert s_port == s_jax
    assert [e["kind"] for e in ev_port] == [e["kind"] for e in ev_jax]
    assert ev_port == ev_jax


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_finishes_every_request(arch):
    cfg = get_smoke_config(arch)
    requests = make_requests(cfg.vocab, 5, (4, 24), (8, 16), seed=3)
    eng, reqs = serve(cfg, requests, device="cpu", dtype=torch.float32,
                      max_num_seqs=4)
    assert eng.metrics.summary()["n_finished"] == len(requests)
    for (_, n), r in zip(requests, reqs):
        assert len(r.output) == n
        assert all(0 <= t < cfg.vocab for t in r.output)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core.engine, "
            "repro_torch.core.runner, repro_torch.launch.serve, "
            "repro_torch.models.bridge, repro_torch.models.ssm, "
            "repro_torch.models.xlstm, repro_torch.core.perf_model, "
            "repro_torch.core.planner, repro_torch.core.router, "
            "repro_torch.cluster, repro_torch.cluster.policies, "
            "repro_torch.cluster.view, repro_torch.cluster.worker, "
            "repro_torch.data.reasoning, repro_torch.lint.sanitizer\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    cfg = get_smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchRunner(Transformer(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve(cfg, make_requests(cfg.vocab, 1, (4, 4), (2, 2), seed=0))
