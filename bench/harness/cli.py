"""``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

One run of one cell: set-up (weights from the seed, the engine, the
warm-up that the cell's traffic needs), a measured window of ``--seconds``,
then the comparison with the plain reference. The last line of standard
output is the result: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit, which also end standard error."""
from __future__ import annotations

import argparse
import functools
import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from harness import check as checks
from harness import spec as specs
from harness import yardstick
from harness.loop import Loop, Spans, clock
from harness.stats import tokens_in_window

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# ranges of the program's whose device time a reader may ask for
RANGES = ("moe_dispatch", "moe_combine")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and its measurements of the control and
    # of planted faults;
    # no run of the benchmark passes them
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--benchmark", default=None, help=argparse.SUPPRESS)  # its BENCHMARK.json
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--witness", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)  # harness.faults
    return ap.parse_args(argv)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class HostWatch:
    """What the host did over the window, for the summary line: the
    process's CPU seconds, the times the kernel took the CPU from it, and
    the collector's pauses."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._gc)
        self.cpu0, self.ru0 = time.process_time(), resource.getrusage(resource.RUSAGE_SELF)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = clock()
        elif self._t is not None:
            self.gc_s += clock() - self._t
            self.gc_n[info["generation"]] += 1

    def close(self) -> Dict:
        gc.callbacks.remove(self._gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"cpu_s": time.process_time() - self.cpu0,
                "nivcsw": ru.ru_nivcsw - self.ru0.ru_nivcsw,
                "gc_s": self.gc_s, "gc_n": self.gc_n,
                "cpus": os.cpu_count()}


def reader(cell: specs.Cell, name: str):
    path = cell.bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Tracer:
    """The profiler over a fixed run of steps from a point in the window."""

    def __init__(self, spans: Spans, start: float, steps: int, cuda: bool):
        self.spans, self.start, self.steps, self.cuda = spans, start, steps, cuda
        self.prof = None
        self.done = 0
        self.result = None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self):
        from torch.profiler import ProfilerActivity, profile
        if self.prof is None and self.result is None and clock() >= self.start:
            self.sync()
            self.prof = profile(activities=[ProfilerActivity.CPU]
                                + [ProfilerActivity.CUDA] * self.cuda)
            self.prof.__enter__()
            self.spans.tracing = True
            self._range = torch.profiler.record_function("bench.harness")
            self._range.__enter__()
        elif self.prof is not None:
            self.done += 1
            if self.done >= self.steps:
                self.stop()

    def stop(self):
        """End the trace (also where the window closed before its steps)."""
        if self.prof is not None:
            self._range.__exit__(None, None, None)
            self.sync()
            self.prof.__exit__(None, None, None)
            self.spans.tracing = False
            self.result, self.prof = self.prof, None


def fold_trace(prof) -> Dict:
    from harness import trace
    events = prof.events()
    outer = [e for e in events if e.name == "bench.harness"]
    window = (min(e.time_range.start for e in outer), max(e.time_range.end for e in outer))
    return trace.fold(events, yardstick.SYMBOLS, RANGES, window)


def run(args) -> int:
    t0 = args.t0
    cell = specs.load_cell(args.workload, specs.BENCH.parent if args.benchmark is None
                           else Path(args.benchmark).resolve().parent)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
    torch.set_num_threads(4)
    device = torch.device(args.device)
    s = specs.model_sizes(cell.config)
    if args.fault:
        from harness import faults
        faults.plant(args.fault)
    from harness import system
    eng = system.build(cell.config, s, args.seed, args.device)
    spans = Spans()
    spans.wrap(eng.runner)
    mix = cell.traffic
    loop = Loop(eng, spans, mix, args.seed, s["V"], eng.ecfg.max_num_seqs)
    plan, at = None, 0
    if mix["loop"] == "closed":
        inflight = loop.setup_closed(system.Request)
    else:
        loop.warm_up()
        plan = loop.schedule(args.seconds)
        at = loop.run_open(plan, clock() + float(mix["warmin_s"]), 0)
        inflight = None
    if args.trace:
        # the profiler's first start is slow: pay it in set-up, not in the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]
                     + [ProfilerActivity.CUDA] * (device.type == "cuda")):
            torch.ones(1, device=device).sum().item()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = clock() - t0
    spans.clear()
    pre0 = eng.sched.n_preemptions
    in_flight_at_open = len(eng.sched.running) + len(eng.sched.waiting)
    submitted_before = len(loop.requests)
    watch = HostWatch()
    steps_before = loop.steps
    t_start = clock()
    tracer = None
    if args.trace:
        tracer = Tracer(spans, t_start + float(mix.get("trace_at", 0.3)) * args.seconds,
                        int(mix.get("trace_steps", 40)), device.type == "cuda")
        loop.on_step = tracer
    if plan is None:
        loop.run_closed(t_start + args.seconds)
    else:
        at = loop.run_open(plan, t_start + args.seconds, at)
    t_close = clock()
    host = watch.close()
    if tracer is not None:
        tracer.stop()
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    preemptions = eng.sched.n_preemptions - pre0

    due_in_window = [t for t, _, _ in (plan or []) if t_start <= t < t_close]
    if plan is None:
        attempted = in_flight_at_open + len(loop.requests) - submitted_before
    else:
        attempted = len(due_in_window)
    finished = [r for r in loop.requests if r.t_finished is not None
                and spans.times.get(r.rid) and spans.times[r.rid][-1] >= t_start]
    obs = SimpleNamespace(
        sizes=s, yard=yardstick, setup_s=setup_s, t_start=t_start, t_close=t_close, window_s=t_close - t_start,
        times=spans.times, due=loop.due, due_in_window=due_in_window,
        open_loop=plan is not None, decode=list(spans.decode), prefill=list(spans.prefill),
        traced_decode=list(spans.traced_decode), traced_prefill=list(spans.traced_prefill),
        preemptions=preemptions, trace=None)
    lateness = sorted(loop.late[r.rid] for r in loop.requests
                      if loop.due[r.rid] >= t_start)
    mid = (t_start + t_close) / 2
    fifth = (t_close - t_start) / 5
    summary = {"cell": cell.name, "seed": args.seed, "setup_s": setup_s,
               "window_s": obs.window_s,
               # each half of the window alone: whether a longer window
               # would narrow the spread between runs
               "output_tok_s_halves": [tokens_in_window(spans.times, a, b) / (b - a)
                                       for a, b in ((t_start, mid), (mid, t_close))],
               "output_tok_s_fifths": [tokens_in_window(spans.times, a, a + fifth) / fifth
                                       for a in (t_start + i * fifth for i in range(5))],
               "inflight_at_setup": inflight,
               "requests_in_window": attempted, "finished_in_window": len(finished),
               "preemptions": preemptions, "decode_calls": len(obs.decode),
               "prefill_calls": len(obs.prefill), "fresh_submitted": loop.n_fresh,
               "decode_ms_mean": 1e3 * sum(b - a for a, b, _ in obs.decode) / max(len(obs.decode), 1),
               "prefill_ms_mean": 1e3 * sum(b - a for a, b, _ in obs.prefill) / max(len(obs.prefill), 1),
               "prefill_tokens": sum(n for _, _, n in obs.prefill),
               "refused": loop.refused, "steps": loop.steps - steps_before, "host": host,
               "generator_late_s": {"p50": lateness[len(lateness) // 2],
                                    "max": lateness[-1]} if lateness else None}
    if tracer is not None and tracer.result is not None:
        obs.trace = fold_trace(tracer.result)
        tracer.result = None
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = reader(cell, m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(json.dumps({"summary": summary}), flush=True)

    # the comparison, once the program's state is freed
    check = cell.check
    chosen = checks.sample(finished, args.seed, int(check["reference_tokens"]))
    records = [SimpleNamespace(rid=r.rid, prompt=list(r.prompt), output=list(r.output))
               for r in chosen]
    del eng, loop, chosen, finished
    spans.touched.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from harness import weights
    from reference.decoder import Decoder, exact_fp32
    exact_fp32()
    leaf = functools.partial(weights.leaf, s, args.seed, device=device,
                             dtype=system.DTYPES[cell.config["torch_dtype"]])
    t_ref = clock()
    rows = checks.gaps(Decoder(s, leaf), records, device,
                       control=Decoder(s, leaf, precision="fp8") if args.control else None)
    if args.witness:
        # the reference's products in bf16, no code of the program's: what
        # bf16 alone moves
        for rid, row in checks.gaps(Decoder(s, leaf), records, device,
                                    control=Decoder(s, leaf, precision="bf16")).items():
            rows[rid]["witness_gaps"] = row["control_gaps"]
    ref_s = clock() - t_ref
    # a control run is judged by the control's gaps in the program's place
    verdict = checks.verdict(rows, check, summary["refused"],
                             key="control_gaps" if args.control else "gaps")
    worst = sorted(rows.items(), key=lambda kv: -max(kv[1]["gaps"]))[:5]
    summary_ref = {"reference_s": ref_s, "requests_compared": len(rows),
                   "numbers": checks.numbers(rows), "fault": args.fault,
                   "widest": {str(k): {"gap": max(v["gaps"]), "tokens": len(v["gaps"])}
                              for k, v in worst}}
    if args.control:
        summary_ref["control"] = checks.numbers(rows, "control_gaps")
    if args.witness:
        summary_ref["bf16_witness"] = checks.numbers(rows, "witness_gaps")
    print(json.dumps({"reference": summary_ref}), flush=True)

    bad = sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
    if bad:
        log(f"the run loaded {bad[:10]}: the benchmark measures the port alone")
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
        dev["peaks"] = {"bf16_flops": yardstick.PEAK_FLOPS_BF16,
                        "hbm_bytes_s": yardstick.PEAK_BYTES_S}
    if args.trace and obs.trace is not None:
        dev["busy_s"] = obs.trace["busy_s"]
        dev["window_s"] = obs.trace["window_s"]
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if args.trace and obs.trace is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in obs.trace["device_ops"]],
                               "idle_gaps": [list(x) for x in obs.trace["idle_gaps"]]}
    result["checks"] = verdict["checks"]
    for name, c in verdict["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv: List[str], t0: float) -> int:
    args = parse(argv)
    args.t0 = t0
    return run(args)
