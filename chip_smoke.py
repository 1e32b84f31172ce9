#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. the card (nvidia-smi name and power limit, torch and CUDA versions),
     then the build of both CUDA kernels from ``src/repro_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, fp32 and
     bf16, on the kernel test cases and the main path's shapes;
  3. each kernel's time at the main path's shapes beside its bound, its
     plain version's time and one PyTorch library call's time;
  4. greedy tokens of a full-width 2-layer fp32 model served on the card
     equal those of the plain path on the CPU, with and without preemption;
  5. the main path: full-depth llama3.2-3b in bf16 serving 16 requests
     through ``InferenceEngine`` -> ``TorchRunner`` with seeded weights,
     then a shorter traced run of the same model (device busy share,
     kernel times);
  6. the ``kernels`` line, then the card line, then as the last line
     ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero. It needs a CUDA card and fails
without one.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# copied from tests/test_kernels.py
FLASH_CASES = [
    # B, Sq, Skv, H, KV, D, window
    (1, 128, 128, 4, 4, 64, 0),
    (2, 128, 128, 8, 2, 32, 0),
    (2, 64, 256, 4, 4, 64, 0),
    (1, 256, 256, 6, 2, 128, 0),
    (2, 128, 128, 4, 1, 64, 0),
    (1, 256, 256, 4, 4, 64, 64),
    (1, 192, 192, 4, 2, 64, 32),
]
PAGED_CASES = [
    # B, KV, G, D, page, P, nblk
    (2, 2, 4, 64, 16, 16, 4),
    (3, 4, 1, 64, 16, 32, 6),
    (1, 1, 8, 128, 16, 8, 8),
    (4, 2, 2, 32, 16, 64, 3),
]
# the main path's shapes: llama3.2-3b has 24 q heads over 8 kv heads of 128
MAIN_FLASH = [(1, S, S, 24, 8, 128, 0) for S in (512, 2048)]
# served prompts are ragged (ISL 128-1024): partial q and kv tiles
RAGGED_FLASH = [(1, S, S, 24, 8, 128, 0) for S in (1000, 137)]
MAIN_PAGED = dict(B=16, KV=8, G=3, D=128, max_ctx=2048)
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# the device kernel each wrapper launches, as the profiler names it
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd", "paged_attention": "paged_decode"}
# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside the tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SERVE_REQUESTS = dict(n=16, isl=(128, 1024), osl=(128, 256), seed=0)


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def flash_inputs(case, dtype, gen):
    B, Sq, Skv, H, KV, D, window = case
    dev = torch.device("cuda")
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    lens = torch.tensor([Skv] + [max(Skv // 2, 1)] * (B - 1),
                        dtype=torch.int32, device=dev)
    return q, k, v, lens, window


def paged_case_inputs(case, dtype, gen):
    B, KV, G, D, page, P, nblk = case
    dev = torch.device("cuda")
    q = torch.randn((B, KV, G, D), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((P, page, KV, D), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    tables = torch.randint(0, P, (B, nblk), generator=gen, device=dev,
                           dtype=torch.int32)
    lens = torch.tensor([nblk * page - 1] + [page // 2] * (B - 1),
                        dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens


def paged_main_inputs(dtype, gen):
    """B sequences of up to max_ctx tokens in shuffled pages of one pool."""
    m = MAIN_PAGED
    B, KV, G, D, page = m["B"], m["KV"], m["G"], m["D"], 16
    rng = np.random.default_rng(1)
    ctx = rng.integers(128, m["max_ctx"] + 1, size=B)
    ctx[0] = m["max_ctx"]
    n_blocks = -(-ctx // page)
    P = int(n_blocks.sum()) + 64
    perm = rng.permutation(P).astype(np.int32)
    tables = np.zeros((B, int(n_blocks.max())), np.int32)
    used = 0
    for b, n in enumerate(n_blocks):
        tables[b, :n] = perm[used:used + n]
        used += n
    dev = torch.device("cuda")
    q = torch.randn((B, KV, G, D), generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn((P, page, KV, D), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    return (q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ctx - 1).to(dev, torch.int32))


# ------------------------------------------------------------------ phases
def compare(fn, plain, args, kwargs, dtype):
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    ref = plain(*args, **kwargs)
    diff = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{fn.__name__}: non-finite output")
    ok = bool((diff <= tol + tol * ref.float().abs()).all())
    err = float(diff.max())
    if not ok:
        raise AssertionError(f"{fn.__name__}: max abs err {err} beyond tol "
                             f"{tol} at {[tuple(a.shape) for a in args[:3]]}")
    return err


def check_kernels(flash_ops, paged_ops):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"flash_attention": [], "paged_attention": []}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES + MAIN_FLASH + RAGGED_FLASH:
            q, k, v, lens, window = flash_inputs(case, dtype, gen)
            errs["flash_attention"].append(compare(
                flash_ops.flash_attention, flash_ops.flash_attention_plain,
                (q, k, v, lens), {"window": window}, dtype))
        cases = [paged_case_inputs(c, dtype, gen) for c in PAGED_CASES]
        for args in cases + [paged_main_inputs(dtype, gen)]:
            errs["paged_attention"].append(compare(
                paged_ops.paged_attention, paged_ops.paged_attention_plain,
                args, {}, dtype))
    for name, e in errs.items():
        emit("check", kernel=name, cases=len(e), max_abs_err=max(e),
             errs=[float(f"{x:.3g}") for x in e])
    return {name: max(e) for name, e in errs.items()}


def time_ms(fn, iters, warmup=3):
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def time_flash(flash_ops, case, dtype, gen):
    import torch.nn.functional as F
    q, k, v, lens, _ = flash_inputs(case, dtype, gen)
    B, Sq, Skv, H, KV, D, _ = case
    lens_np = lens.cpu().numpy()
    # causal (q, k) pairs these inputs need: row i sees min(i+1, lens[b]) keys
    pairs = sum(int(np.minimum(np.arange(1, Sq + 1), lb).sum()) for lb in lens_np)
    flops = 4 * D * H * pairs
    out = flash_ops.flash_attention(q, k, v, lens)
    b_ms, b_by = bound(flops, nbytes(q, k, v, lens, out), dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return dict(
        shape=list(case[:6]), dtype=str(dtype).split(".")[-1],
        ms=time_ms(lambda: flash_ops.flash_attention(q, k, v, lens), 20),
        plain_ms=time_ms(lambda: flash_ops.flash_attention_plain(q, k, v, lens), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
        bound_ms=b_ms, bound_by=b_by, flops=flops)


def time_paged(paged_ops, dtype, gen):
    import torch.nn.functional as F
    q, kp, vp, tables, lens = paged_main_inputs(dtype, gen)
    B, KV, G, D = q.shape
    tokens = int((lens.long() + 1).sum())
    flops = 4 * G * D * KV * tokens
    out = paged_ops.paged_attention(q, kp, vp, tables, lens)
    elem = q.element_size()
    needed = 2 * tokens * KV * D * elem + nbytes(q, out, tables, lens)
    b_ms, b_by = bound(flops, needed, dtype)
    # the library yardstick reads the same pages gathered into a contiguous
    # cache (gathered outside the timed region)
    S = tables.shape[1] * kp.shape[1]
    kc, vc = (p[tables.long()].reshape(B, S, KV, D).transpose(1, 2).contiguous()
              for p in (kp, vp))
    mask = (torch.arange(S, device=q.device)[None, :] <= lens[:, None].long())
    mask = mask[:, None, None, :]
    qh = q.reshape(B, KV * G, 1, D)
    return dict(
        shape=[B, KV, G, D], contexts=(lens + 1).tolist(),
        dtype=str(dtype).split(".")[-1],
        ms=time_ms(lambda: paged_ops.paged_attention(q, kp, vp, tables, lens), 50),
        plain_ms=time_ms(lambda: paged_ops.paged_attention_plain(
            q, kp, vp, tables, lens), 10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kc, vc, attn_mask=mask, enable_gqa=True), 50),
        bound_ms=b_ms, bound_by=b_by, bytes=needed)


def greedy_equality():
    """A full-width 2-layer fp32 model with numpy-seeded weights, served on
    the card through the kernels and on the CPU through the plain path."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.models.bridge import from_jax_params, numpy_params

    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2)
    params = numpy_params(cfg, seed=1)
    models = {dev: from_jax_params(params, cfg, device=dev, dtype=torch.float32)
              for dev in ("cuda", "cpu")}
    del params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=30).tolist() for _ in range(4)]
    n_new = 20
    result = {}
    for label, n_pages in (("ample", 64), ("preempting", 7)):
        outs, preempts = {}, {}
        for dev, model in models.items():
            ecfg = EngineConfig(n_pages=n_pages, max_num_seqs=4,
                                max_num_batched_tokens=512, chunk_size=192,
                                admission_mode="naive")
            eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device=dev),
                                  virtual_clock=False)
            reqs = [eng.submit(p, n_new) for p in prompts]
            eng.run(max_steps=5000)
            outs[dev] = [r.output for r in reqs]
            preempts[dev] = sum(r.n_preemptions for r in reqs)
            if any(len(o) != n_new for o in outs[dev]):
                raise AssertionError(f"{label}/{dev}: unfinished requests")
        if outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"{label}: card tokens {outs['cuda']} differ "
                                 f"from CPU plain-path tokens {outs['cpu']}")
        if label == "preempting" and preempts["cuda"] == 0:
            raise AssertionError("the small pool forced no preemption")
        result[label] = dict(tokens_equal=True, preemptions=preempts)
    return result


def main_path(flash_ops, paged_ops):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_requests, serve

    cfg = get_config("llama3.2-3b")
    r = SERVE_REQUESTS
    requests = make_requests(cfg.vocab, r["n"], r["isl"], r["osl"], r["seed"])
    torch.cuda.reset_peak_memory_stats()
    flash_ops.KERNEL.launches = 0
    paged_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    eng, reqs = serve(cfg, requests, device="cuda", dtype=torch.bfloat16,
                      seed=0, max_num_seqs=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_ops.KERNEL.launches,
                "paged_attention": paged_ops.KERNEL.launches}
    for (prompt, n), req in zip(requests, reqs):
        if len(req.output) != n or req.t_finished is None:
            raise AssertionError(f"request {req.rid}: {len(req.output)} of {n} tokens")
        if not all(0 <= t < cfg.vocab for t in req.output):
            raise AssertionError(f"request {req.rid}: token out of range")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not on the main path: {launches}")
    # the served model still answers: finite logits whose argmax is the
    # first token the engine produced for request 0
    logits, _, _ = eng.runner.model.prefill(
        torch.tensor([requests[0][0]], device="cuda"))
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("non-finite logits")
    if int(logits[0].argmax()) != reqs[0].output[0]:
        raise AssertionError("prefill argmax differs from the served first token")
    s = eng.metrics.summary()
    emit("main_path", model=cfg.name, layers=cfg.n_layers, dtype="bfloat16",
         n_requests=len(requests), n_finished=s["n_finished"],
         gen_tokens=s["gen_tokens"], gen_tok_s=s["gen_throughput_tok_s"],
         ttft_p50_s=s["ttft_s"]["p50"], tpot_mean_s=s["tpot_s"]["mean"],
         preemptions=s["preemptions"], engine_s=s["duration_s"],
         wall_s_with_weight_init=wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches)
    return launches, eng.runner.model


def profile_main_path(model):
    """A traced run of the main path's model, on a fresh engine and pool,
    with 32 output tokens a request. Tracing slows the host, so its step
    times are not the main path's; it gives the device's busy share and the
    kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import EngineConfig, InferenceEngine
    from repro_torch.core.runner import TorchRunner
    from repro_torch.launch.serve import make_requests, pages_to_hold

    cfg = model.cfg
    r = SERVE_REQUESTS
    requests = make_requests(cfg.vocab, r["n"], r["isl"], (32, 32), r["seed"] + 1)
    ecfg = EngineConfig(n_pages=pages_to_hold(requests), max_num_seqs=16,
                        admission_mode="kv_aware")
    eng = InferenceEngine(cfg, ecfg, TorchRunner(model, device="cuda"),
                          virtual_clock=False)
    for prompt, n in requests:
        eng.submit(prompt, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) \
                + evt.time_range.elapsed_us() / 1e3
    groups = dict.fromkeys(("flash_attention", "paged_attention", "matmul",
                            "other"), 0.0)
    for name, ms in by_name.items():
        low = name.lower()
        kernel = [k for k, sym in KERNEL_SYMBOLS.items()
                  if re.search(rf"(^|[\s:]){sym}<", name)]
        if kernel:
            groups[kernel[0]] += ms
        elif any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy_ms = sum(by_name.values())
    steps = len(eng.metrics.timeline)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    emit("profile", osl=32, steps=steps, wall_ms=wall_ms,
         step_ms=wall_ms / max(steps, 1), device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
         device_ms_by_group=groups,
         top_kernels_ms=[[name[:100], ms] for name, ms in top])
    missing = [k for k in KERNEL_SYMBOLS if groups[k] == 0.0]
    if missing:
        raise AssertionError(f"the trace shows no device time for {missing}; "
                             f"its kernels: {sorted(by_name)[:20]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is False)")
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = kbuild.build([flash_ops.KERNEL.name, paged_ops.KERNEL.name])
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas=ptxas)

    max_err = check_kernels(flash_ops, paged_ops)

    gen = torch.Generator(device="cuda").manual_seed(1)
    timings = {"flash_attention": [time_flash(flash_ops, c, torch.bfloat16, gen)
                                   for c in MAIN_FLASH],
               "paged_attention": [time_paged(paged_ops, torch.bfloat16, gen)]}
    for name, rows in timings.items():
        for row in rows:
            emit("timing", kernel=name, **row)

    emit("greedy_equality", **greedy_equality())
    launches, model = main_path(flash_ops, paged_ops)
    profile_main_path(model)
    del model

    replaces = {
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
        "paged_attention": "src/repro/kernels/paged_attention/kernel.py:79",
    }
    kernels = []
    for name in ("flash_attention", "paged_attention"):
        row = timings[name][-1]     # flash at S=2048; paged at its main shape
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "dtype": row["dtype"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
