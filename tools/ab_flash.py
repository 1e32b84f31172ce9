#!/usr/bin/env python3
"""K1 (the flash-attention prefill) or K2 (the paged decode) of two
checkouts compared on one NVIDIA card: the SASS of each instance and the
device time at the main paths' shapes.

    git archive <parent> | tar -x -C build/ab_parent
    python3 tools/ab_flash.py --tree parent=build/ab_parent --tree change=. \
        --order parent,change,change,parent,parent,change \
        [--kernel flash|paged|cvt|upcast|split|simt] [--sass-only]

Each checkout builds its own libraries (``flash_attention`` and
``flash_attention_noncausal``; ``paged_attention`` with ``--kernel paged``,
and the three with ``simt``;
``paged_attention_cvt``, K2 over pages of another dtype than q, with
``--kernel cvt``; ``paged_attention_upcast``, K2's upcast mode, with
``--kernel upcast``; in its ``src/repro_torch/build``); ``cuobjdump -sass``
lists its functions, and a line per instance (``flash_fwd_wgmma``, and
``flash_fwd_simt`` with ``--kernel simt``; ``paged_split_mma``,
``paged_split_simt`` and ``paged_merge``; ``paged_split_cvt``,
``stats_merge``, ``part_sum`` and ``paged_cluster_cvt``;
``paged_split_cvt``, ``cvt_merge`` and ``paged_cluster_upcast``) gives its
instruction count and a hash of its instructions (addresses dropped), so
two builds of the same device code hash alike; a ``sass_summary`` line a
library then says which of the first tree's instances hash alike in the
second (the instances' names may differ where a template gained a
parameter). Then (unless ``--sass-only``) one process per entry of
``--order`` times the kernel with that checkout's own ``chip_smoke.py``:
``time_flash`` (the causal kernel), ``time_paged`` (bf16 and fp32 at
llama3.2-3b's decode batch, bf16 at h2o-danube's and llama3-405b's) or
``time_q8`` (the default mode over fp8 and int8 pages under a bf16 q at the
four ``Q8_PAGED`` shapes, the reasoning lengths of ``Q8_REASONING`` and
h2o-danube's rows under one and three kv heads of ``ODD_KV``; the upcast
mode over fp8 and int8 pages at the same shapes and over fp32 pages at
llama3.2-3b's batch, with SDPA's time on the pre-gathered upcast cache;
each row naming the design that ran: a tree before the map over token
pairs runs its four-launch partition passes, or its upcast split, at
``ODD_KV``); ``device_ms`` from
a replayed CUDA graph. ``--kernel split``: the SASS of every library
(K1's two, the same-dtype K2's, the cvt and upcast libraries', and
``paged_attention_split``'s ``paged_split_stats`` and
``paged_split_values``), then ``time_split_q8`` on each half of
llama3.2-3b's and h2o-danube's decode batches, of the reasoning lengths at
G 16 and G 8 and of ``ODD_KV``'s rows, fp8 and int8 pages: the sequence
split's launches as the tree runs them (a tree before the map over token
pairs: its partition passes at ``ODD_KV``). ``--kernel simt``: the fp32
SIMT instances, the SASS of both K1 libraries' ``flash_fwd_wgmma`` and
``flash_fwd_simt`` (the bf16 instances must hash alike) and of the
same-dtype K2's, then K1's ``flash_fwd_simt`` at ``SIMT_CASES`` and K2's
``paged_split_simt`` plus its merge at llama3.2-3b's decode batch
(``time_flash``, ``time_paged``: the bound at the fp32 rate, SDPA on the
same fp32 tensors, K2's cache pre-gathered). ``--kernel flash`` compares
both K1 libraries' ``flash_fwd_wgmma``. Lines also go to
``ab_flash.jsonl`` in the output directory (``OUT``), which each call
rewrites.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "ab_flash.jsonl"
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
# llama3.2-3b's longest prompt row, h2o-danube's windowed prompt, a ragged one
CASES = [(1, 2048, 2048, 24, 8, 128, 0), (1, 5000, 5000, 32, 8, 120, 4096),
         (1, 1000, 1000, 24, 8, 128, 0)]
# K1's fp32 rows (``chip_smoke.FP32_FLASH_TIMED``; (case, causal)), the
# same for every tree: llama3.2-3b's heads at S 1000 and 2048, zamba2's,
# the swa equality run's 4200-token prompt under the window, S 1000
# non-causal
SIMT_CASES = [((1, 1000, 1000, 24, 8, 128, 0), True), ((1, 2048, 2048, 24, 8, 128, 0), True),
              ((1, 1000, 1000, 32, 32, 80, 0), True),
              ((1, 4200, 4200, 32, 8, 120, 4096), True),
              ((1, 1000, 1000, 24, 8, 128, 0), False)]
# h2o-danube's rows at tp 8 (one kv head of 120 a rank, its window) and
# under three kv heads: 8-bit rows whose token stride is no 16-byte multiple
ODD_KV = [dict(B=16, KV=kv, G=4, D=120, min_ctx=4096, max_ctx=6400, window=4096)
          for kv in (1, 3)]


def emit(**kw):
    line = json.dumps(kw)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


# --kernel -> [(library, the functions whose SASS is compared)]
KERNELS = {"flash": [("flash_attention", ("flash_fwd_wgmma",)),
                     ("flash_attention_noncausal", ("flash_fwd_wgmma",))],
           "paged": [("paged_attention", ("paged_split_mma", "paged_split_simt",
                                          "paged_merge"))],
           "cvt": [("paged_attention_cvt", ("paged_split_cvt", "stats_merge", "part_sum",
                                            "paged_cluster_cvt"))],
           "upcast": [("paged_attention_upcast", ("paged_split_cvt", "cvt_merge",
                                                  "paged_cluster_upcast"))]}
KERNELS["split"] = [("flash_attention", ("flash_fwd",)),
                    ("flash_attention_noncausal", ("flash_fwd",)),
                    *KERNELS["paged"],
                    *KERNELS["cvt"], *KERNELS["upcast"],
                    ("paged_attention_split", ("paged_split_stats", "paged_split_values"))]
KERNELS["simt"] = [("flash_attention", ("flash_fwd_wgmma", "flash_fwd_simt")),
                   ("flash_attention_noncausal", ("flash_fwd_wgmma", "flash_fwd_simt")),
                   *KERNELS["paged"]]


def _import(tree: Path, kernel: str):
    src = (tree / "src").resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    if not Path(build.__file__).resolve().is_relative_to(src):
        raise AssertionError(f"imported {build.__file__}, not {src}")
    build.build(_libraries(build, kernel))
    return build


def _libraries(build, kernel: str):
    """The kernel's libraries that the checkout has (a parent may predate
    one)."""
    return [lib for lib, _ in KERNELS[kernel] if (build.CSRC / f"{lib}.cu").exists()]


def sass(label: str, tree: Path, kernel: str):
    """One line per instance of the checkout's build."""
    build = _import(tree, kernel)
    for lib, names in KERNELS[kernel]:
        if lib not in _libraries(build, kernel):
            continue
        text = subprocess.run([CUOBJDUMP, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        for fn in re.split(r"\n\s*Function : ", text)[1:]:
            name, body = fn.split("\n", 1)
            if not any(n in name for n in names):
                continue
            ins = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
                   for ln in body.splitlines() if "/*" in ln]
            emit(phase="sass", tree=label, library=lib, function=name.strip(),
                 instructions=len(ins),
                 sha1=hashlib.sha1("\n".join(ins).encode()).hexdigest()[:12])


def sass_summary(labels):
    """For each library, the first tree's instances whose instructions hash
    alike among the second's, and those that do not."""
    lines = [json.loads(ln) for ln in OUT.read_text().splitlines()]
    rows = [r for r in lines if r.get("phase") == "sass"]
    a, b = labels[:2]
    for lib in sorted({r["library"] for r in rows}):
        theirs = {r["sha1"] for r in rows if r["library"] == lib and r["tree"] == b}
        mine = [r for r in rows if r["library"] == lib and r["tree"] == a]
        emit(phase="sass_summary", library=lib, trees=[a, b], instances=len(mine),
             same=sum(r["sha1"] in theirs for r in mine),
             changed=[r["function"] for r in mine if r["sha1"] not in theirs])


def _emit_q8(label, r):
    emit(phase="timing", tree=label, **{k: r.get(k) for k in (
        "shape", "window", "pages", "mode", "design", "ms", "device_ms", "bound_ms", "bound_by",
        "plain_ms", "library_ms", "library_device_ms")})


def timing(label: str, tree: Path, kernel: str):
    """The causal kernel's rows at ``CASES``, or K2's at ``chip_smoke``'s
    shapes, by the tree's own ``chip_smoke``."""
    sys.path.insert(0, str(tree.resolve()))
    import torch

    import chip_smoke as cs
    _import(tree, kernel)
    gen = torch.Generator(device="cuda").manual_seed(1)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    if kernel == "simt":
        for case, causal in SIMT_CASES:
            r = cs.time_flash(flash_ops, case, torch.float32, gen, causal=causal)
            emit(phase="timing", tree=label, kernel="flash_attention", **r)
        r = cs.time_paged(paged_ops, torch.float32, gen, cs.MAIN_PAGED)
        emit(phase="timing", tree=label, kernel="paged_attention", **r)
        return
    if kernel == "split":
        for m in (cs.MAIN_PAGED, cs.DANUBE_PAGED, *cs.Q8_REASONING, *ODD_KV):
            for pages in (torch.float8_e4m3fn, torch.int8):
                for r in cs.time_split_q8(paged_ops, pages, gen, m):
                    emit(phase="timing", tree=label, **r)
        return
    if kernel in ("cvt", "upcast"):
        upcast = kernel == "upcast"
        for m in (*cs.Q8_PAGED, *cs.Q8_REASONING, *ODD_KV):
            for pages in (torch.float8_e4m3fn, torch.int8):
                _emit_q8(label, cs.time_q8(paged_ops, pages, upcast, gen, m))
        if upcast:
            _emit_q8(label, cs.time_q8(paged_ops, torch.float32, True, gen, cs.MAIN_PAGED))
        return
    if kernel == "paged":
        for dtype, m in ((torch.bfloat16, cs.MAIN_PAGED), (torch.float32, cs.MAIN_PAGED),
                         (torch.bfloat16, cs.DANUBE_PAGED), (torch.bfloat16, cs.L405_PAGED)):
            r = cs.time_paged(paged_ops, dtype, gen, m)
            emit(phase="timing", tree=label, shape=r["shape"], window=r["window"],
                 dtype=r["dtype"], ms=r["ms"], device_ms=r["device_ms"])
        return
    for case in CASES:
        r = cs.time_flash(flash_ops, case, torch.bfloat16, gen)
        emit(phase="timing", tree=label, shape=r["shape"], window=r["window"],
             ms=r["ms"], device_ms=r["device_ms"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="label=path")
    ap.add_argument("--order", help="comma-separated labels, one timing run each")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="flash")
    ap.add_argument("--sass-only", action="store_true", help="compare SASS, time nothing")
    ap.add_argument("--run", nargs=3, metavar=("WHAT", "LABEL", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        what, label, path = args.run
        (sass if what == "sass" else timing)(label, Path(path), args.kernel)
        return
    trees = dict(t.split("=", 1) for t in args.tree)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(phase="device", nvidia_smi=smi.stdout.strip())
    for label, path in trees.items():
        subprocess.run([sys.executable, __file__, "--kernel", args.kernel, "--run",
                        "sass", label, path], check=True, cwd=ROOT)
    if len(trees) > 1:
        sass_summary(list(trees))
    for label in [] if args.sass_only else (args.order or ",".join(trees)).split(","):
        subprocess.run([sys.executable, __file__, "--kernel", args.kernel, "--run",
                        "timing", label, trees[label]], check=True, cwd=ROOT)


if __name__ == "__main__":
    main()
