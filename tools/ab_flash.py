#!/usr/bin/env python3
"""K1 (the flash-attention prefill) of two checkouts compared on one NVIDIA
card: the SASS of each ``flash_fwd_wgmma`` instance and the device time of
the causal kernel at the main paths' longest shapes.

    git archive <parent> | tar -x -C build/ab_parent
    python3 tools/ab_flash.py --tree parent=build/ab_parent --tree change=. \
        --order parent,change,change,parent,parent,change

Each checkout builds its own ``flash_attention`` library (in its
``src/repro_torch/build``); ``cuobjdump -sass`` lists its functions, and a
line per ``flash_fwd_wgmma`` instance gives its instruction count and a
hash of its instructions (addresses dropped), so two builds of the same
device code hash alike. Then one process per entry of ``--order`` times
the causal kernel with ``chip_smoke.time_flash`` (``device_ms`` from a
replayed CUDA graph). Lines also go to ``chiprun_out/ab_flash.jsonl``.
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


def emit(**kw):
    line = json.dumps(kw)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _import(tree: Path):
    src = (tree / "src").resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    if not Path(build.__file__).resolve().is_relative_to(src):
        raise AssertionError(f"imported {build.__file__}, not {src}")
    build.build(["flash_attention"])
    return build


def sass(label: str, tree: Path):
    """One line per ``flash_fwd_wgmma`` instance of the checkout's build."""
    so = _import(tree).library_path("flash_attention")
    text = subprocess.run([CUOBJDUMP, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = fn.split("\n", 1)
        if "flash_fwd_wgmma" not in name:
            continue
        ins = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
               for ln in body.splitlines() if "/*" in ln]
        emit(phase="sass", tree=label, function=name.strip(), instructions=len(ins),
             sha1=hashlib.sha1("\n".join(ins).encode()).hexdigest()[:12])


def timing(label: str, tree: Path):
    """The causal kernel's rows at ``CASES``."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    _import(tree)
    from repro_torch.kernels.flash_attention import ops as flash_ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case in CASES:
        r = cs.time_flash(flash_ops, case, torch.bfloat16, gen)
        emit(phase="timing", tree=label, shape=r["shape"], window=r["window"],
             ms=r["ms"], device_ms=r["device_ms"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="label=path")
    ap.add_argument("--order", help="comma-separated labels, one timing run each")
    ap.add_argument("--run", nargs=3, metavar=("WHAT", "LABEL", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        what, label, path = args.run
        (sass if what == "sass" else timing)(label, Path(path))
        return
    trees = dict(t.split("=", 1) for t in args.tree)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(phase="device", nvidia_smi=smi.stdout.strip())
    for label, path in trees.items():
        subprocess.run([sys.executable, __file__, "--run", "sass", label, path],
                       check=True, cwd=ROOT)
    for label in (args.order or ",".join(trees)).split(","):
        subprocess.run([sys.executable, __file__, "--run", "timing", label,
                        trees[label]], check=True, cwd=ROOT)


if __name__ == "__main__":
    main()
