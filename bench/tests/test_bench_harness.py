"""The benchmark on the CPU at smoke sizes: one run of each mix, the
arithmetic of its metrics, its independence from the JAX package, and a
cell added by files alone."""
from __future__ import annotations

import ast
import json
import math
import shutil
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

import smoke
from harness import spec, stats, traffic, weights, yardstick
from reference.decoder import Decoder

BENCH = smoke.BENCH
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return smoke.make(tmp_path_factory.mktemp("bench"))


def cells():
    return [w["name"] for w in json.loads((smoke.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_prints_one_result_line(copy, cell, trace):
    proc = smoke.run(copy, cell, trace=trace)
    out = smoke.result(proc)
    assert tuple(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    entries = json.loads((copy / "BENCHMARK.json").read_text())
    want = spec.metrics_of(entries["per_layer" if trace else "end_to_end"], cell)
    # on the CPU no device trace: the trace's readers find nothing to read
    host = {m["name"] for m in want if m["source"] != "device_trace"}
    assert host <= set(out["metrics"]) <= {m["name"] for m in want}
    assert all(v["value"] is not None and v["unit"] for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"
    # each number compared, beside its limit, ends standard error
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert [line.split()[0] for line in tail] == list(out["checks"])


def test_no_card_no_result(copy):
    """Without --device cpu the harness looks for a card, finds none here,
    exits with another code than 0 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = smoke.subprocess.run(
        [smoke.sys.executable, "bench/run.py", "--workload", cells()[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=copy, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory holding only BENCHMARK.json and the files under paths
    (no port to measure) exits with another code than 0, no result."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(smoke.ROOT / "BENCHMARK.json", tmp_path)
    proc = smoke.run(tmp_path, cells()[0])
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_cell_added_by_files_alone(copy, tmp_path):
    """A new mix and a new cell are a data file and an entry: nothing that
    was there is edited."""
    root = tmp_path / "root"
    shutil.copytree(copy, root, symlinks=True)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    mix = json.loads((root / "bench" / "traffic" / "longprompt_open.json").read_text())
    mix.update(smoke.SHORT, rate_per_s=30.0, warmin_s=1, check={"logit_gap_limit": 2.5})
    (root / "bench" / "traffic" / "chat_open.json").write_text(json.dumps(mix))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "moe.chat_open", "config": "tiny-moe",
                           "traffic": "chat_open", "chips": 1, "why": "added by a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = smoke.result(smoke.run(root, "moe.chat_open"))
    assert out["correct"] and "itl_p95_ms" in out["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("trace", [0, 1])
def test_an_open_loop_cell_added_by_entries_alone(copy, tmp_path, trace):
    """The long-prompt mix as a cell of its own, with its time to first
    token and its prefill's per-layer metrics: a cell file and entries in
    BENCHMARK.json, over the mix and the readers already there."""
    root = tmp_path / "root"
    shutil.copytree(copy, root, symlinks=True)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    (root / "bench" / "cells" / "dense.longprompt.json").write_text(json.dumps(
        dict(smoke.SHORT, rate_per_s=20.0, warmin_s=1, check={"logit_gap_limit": 0.25})))
    b = json.loads((root / "BENCHMARK.json").read_text())
    cell = "dense.longprompt"
    b["workloads"].append({"name": cell, "config": "tiny-dense", "traffic": "longprompt_open",
                           "chips": 1, "why": "added by a test"})
    b["end_to_end"].append({"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
                            "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    for name, unit, source in (("prefill_tok_s", "tokens/s", "program_span"),
                               ("mfu.prefill", "%", "program_span"),
                               ("k1_roofline", "%", "device_trace"),
                               ("idle_share.prompt", "%", "device_trace")):
        b["per_layer"].append({"name": name, "unit": unit, "better": "higher", "source": source,
                               "layer": "kernels", "moves": "ttft_p95_ms", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    out = smoke.result(smoke.run(root, cell, trace=trace))
    assert out["correct"] and out["failed"] == 0
    # on the CPU the device trace's readers may find nothing to read
    host = {"prefill_tok_s", "mfu.prefill"} if trace else {"ttft_p95_ms", "itl_p95_ms", "setup_s"}
    assert host <= set(out["metrics"]) <= host | {"k1_roofline", "idle_share.prompt"}
    assert all(p.read_bytes() == data for p, data in before.items())


# ---------------------------------------------------------------- arithmetic

def test_percentile_rate_and_window():
    times = {1: [0.5, 1.0, 1.1, 1.3], 2: [1.2, 2.0], 3: [3.5]}
    assert stats.tokens_in_window(times, 1.0, 2.0) == 5
    gaps = sorted(stats.inter_token_gaps(times, 1.0, 2.0))
    assert gaps == pytest.approx([0.1, 0.2, 0.5, 0.8])
    assert stats.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    due = {1: 1.0, 2: 1.1, 3: 0.5}
    # 1 and 2 are due in [1, 2): 1's first token precedes its due time
    # (never in a run); 2 has none by the close and counts its age
    assert stats.ttfts({1: [1.25], 2: []}, due, [1.0, 1.1, 1.9], 1.0, 2.0) == \
        pytest.approx([0.25, 0.9, 0.1])
    values = [1.0, 2.0, 3.0, 4.0, 100.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / 3.0)


def sizes(name="h2o-danube-3-4b"):
    return spec.model_sizes(json.loads((BENCH / "configs" / f"{name}.json").read_text()))


def test_counts_by_hand():
    s = sizes()
    per_layer = 3840 * 32 * 120 * 2 + 3840 * 8 * 120 * 2 + 3 * 3840 * 10240
    assert yardstick.layer_matmul_params(s) == per_layer
    assert 24 * per_layer + 3840 * 32000 + 32000 * 3840 == 3961839360 - 2 * 3840 * 24 - 3840
    # full attention: every key at or before the query
    assert yardstick.attended(s, 0) == 1 and yardstick.attended(s, 10_000) == 10_001
    assert yardstick.causal_pairs(s, 5000) == 5000 * 5001 // 2
    # under a window of 4096: 4096 keys at most, the query itself among them
    w = dict(s, window=4096)
    assert yardstick.attended(w, 0) == 1 and yardstick.attended(w, 10_000) == 4096
    assert yardstick.causal_pairs(w, 4096) == 4096 * 4097 // 2
    assert yardstick.causal_pairs(w, 5000) == 4096 * 4097 // 2 + 904 * 4096
    # a decode row at position 99 of a 24-layer model
    assert yardstick.decode_flops(s, [99]) == 2 * (24 * per_layer + 3840 * 32000) \
        + 4 * 100 * 120 * 32 * 24
    # K2: k and v of 100 keys in 8 kv heads and q, out of 32 heads, 24 layers, bf16
    assert yardstick.k2_bytes(s, [99]) == 24 * (2 * 100 * 8 * 120 + 2 * 32 * 120) * 2
    # K1 at 5000 tokens is bound by its operations
    ops = 4 * 5000 * 5001 // 2 * 120 * 32
    assert yardstick.k1_bound_s(s, 5000) == pytest.approx(24 * ops / 989e12)
    phi = sizes("phi3.5-moe.pp2")
    assert yardstick.layer_matmul_params(phi) == \
        4096 * 4096 * 2 + 4096 * 1024 * 2 + 4096 * 16 + 2 * 3 * 4096 * 6400


def test_counts_against_the_dry_run_counter():
    """The model's prefill operations against the port's dry-run counter
    (``analysis/counter.py``) over its prefill on meta tensors at one shape."""
    from repro_torch.analysis.counter import OpCounter
    from repro_torch.models.transformer import Transformer

    from harness import system
    cfg = smoke.WINDOWED
    s = spec.model_sizes(cfg)
    model = Transformer(system.model_config(cfg, s), device="meta", seed=None)
    n = 40
    with OpCounter() as c:
        model.prefill(torch.zeros((1, n), dtype=torch.long, device="meta"))
    assert c.flops == yardstick.prefill_flops(s, n)


def test_stratified_sizes_are_the_seeds_alike():
    mix = json.loads((BENCH / "traffic" / "reasoning_inflight.json").read_text())
    pool = traffic.size_pool(mix, 4096)
    isl = np.array([a for a, _ in pool])
    osl = np.array([b for _, b in pool])
    # the paper's profile: ISL median 95, OSL median 4200, 45% past 5000
    assert np.median(isl) == pytest.approx(95, abs=1)
    assert np.median(osl) == pytest.approx(4200, rel=0.01)
    assert (osl > 5000).mean() == pytest.approx(0.43, abs=0.03)
    flight = traffic.inflight_pool(mix, 512)
    ctx = np.array([i + p for i, _, p in flight])
    # sequences caught in flight: longer than fresh ones (length-biased)
    assert np.median([o for _, o, _ in flight]) > 2 * np.median(osl)
    assert all(0 <= p < o for _, o, p in flight) and ctx.mean() > 5000
    a, b = (sorted(traffic.order(seed, 100, 2)) for seed in (1, 2 ** 31 + 5))
    assert a == b == list(range(100))


# ---------------------------------------------------------------- reference

@pytest.mark.parametrize("name", [*smoke.CONFIGS, "tiny-swa"])
def test_reference_matches_the_port_in_fp32(name):
    """The plain reference and the port's fp32 model on the same weights
    give the same logits (the reference knows nothing of the port)."""
    from repro_torch.models.transformer import Transformer

    from harness import system
    cfg = dict({**smoke.CONFIGS, "tiny-swa": smoke.WINDOWED}[name], torch_dtype="float32")
    s = spec.model_sizes(cfg)
    model = Transformer(system.model_config(cfg, s), device="cpu",
                        dtype=torch.float32, seed=None)
    weights.fill(dict(model.named_parameters()), s, 11)
    toks = torch.randint(0, s["V"], (37,), generator=torch.Generator().manual_seed(0))
    got = model.prefill(toks[None])[0][0]
    leaf = lambda n, l=0: weights.leaf(s, 11, n, l, device="cpu", dtype=torch.float32)  # noqa: E731
    want = Decoder(s, leaf, q_block=8, row_block=16).logits(toks, 36)[0]
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


def test_a_stacked_layer_is_drawn_as_the_reference_draws_it():
    cfg = smoke.CONFIGS["tiny-moe"]
    s = spec.model_sizes(cfg)
    params = {n: torch.empty(shape, dtype=torch.bfloat16)
              for n, (shape, _) in weights.model_leaves(s).items()}
    weights.fill(params, s, 2 ** 31 + 7)
    for name, layer in (("we_gate", 1), ("wq", 0), ("embed", 0)):
        full = params.get(name) if name in params else params[f"moe_stack.{name}"][layer]
        assert torch.equal(full, weights.leaf(s, 2 ** 31 + 7, name, layer, device="cpu",
                                              dtype=torch.bfloat16))


def test_the_fp8_control_is_further_from_the_reference():
    cfg = smoke.CONFIGS["tiny-dense"]
    s = spec.model_sizes(cfg)
    leaf = lambda n, l=0: weights.leaf(s, 3, n, l, device="cpu", dtype=torch.bfloat16)  # noqa: E731
    toks = torch.randint(0, s["V"], (60,), generator=torch.Generator().manual_seed(1))
    ref = Decoder(s, leaf).logits(toks, 0)
    low = Decoder(s, leaf, precision="fp8").logits(toks, 0)
    assert 0 < (ref - low).abs().max() and not torch.equal(ref.argmax(-1), low.argmax(-1))


# ---------------------------------------------------------------- imports

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    found = {(str(p.relative_to(BENCH)), m) for p in BENCH.rglob("*.py")
             for m in imported(p) if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    found = {(p.name, m) for p in (BENCH / "reference").rglob("*.py") for m in imported(p)
             if m in FORBIDDEN | {"repro_torch", "harness"}}
    assert not found


def test_benchmark_json_keeps_the_contract():
    b = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in b["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in b["workloads"])
    assert all(len(w["why"]) <= 200 and w["chips"] == 1 for w in b["workloads"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", m["workloads"]))
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and math.isfinite(m["bound"])
