#!/usr/bin/env python3
"""Variants of K1's fp32 instance (``flash_fwd_simt``) timed against each
other on one NVIDIA card, to see what holds its time.

    python3 tools/flash_variants.py [--variants base,probe_q_half,...]
        [--order forward,backward] [--sass]

Each variant is a copy of ``src/repro_torch/csrc`` whose
``flash_attention.cuh`` has the text substitutions of ``VARIANTS`` applied,
built with the port's ``nvcc`` flags into ``build/flash_variants/<name>``
(one ``nvcc`` each, all at once), then timed in a process of its own (two
builds of one library's template statics in one process share them): its
largest error against the plain version on four cases, and the device time
(the least of three replayed CUDA graphs of 20 calls) at llama3.2-3b's
heads at S 1000 and 2048 and at zamba2's (1, 1000, 32, 32, 80), causal.
Variants named ``probe_*`` compute a wrong result on purpose (they drop
work to see what it costs); the others must hold the plain version at
2e-3. ``--sass`` prints the instruction mix of each loop of the first
variant's D 128 instance (``cuobjdump -sass``). Lines also go to
``chiprun_out/flash_variants.jsonl``, which each call rewrites.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "flash_variants.jsonl"
WORK = ROOT / "build" / "flash_variants"
HEADER = "flash_attention.cuh"
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
_K_SYNC = "      __syncthreads();  // P is written; every thread is done with the k tile\n"
_V_SYNC = "      __syncthreads();  // every thread is done with P and the v tile\n"
# name -> [(text, replacement)] in flash_attention.cuh
VARIANTS = {
    "base": [],
    # S = Q K^T with half its q loads (rows i and i + 4 read one row)
    "probe_q_half": [("q + 1024 * i);", "q + 1024 * (i & 3));")],
    # S = Q K^T with half its k loads (keys j and j + 2 read one key)
    "probe_k_half": [("k + 2048 * j);", "k + 2048 * (j & 1));")],
    # S = Q K^T with half its loads of both
    "probe_qk_half": [("q + 1024 * i);", "q + 1024 * (i & 3));"),
                      ("k + 2048 * j);", "k + 2048 * (j & 1));")],
    # the softmax's expf of the scores replaced by one FMA
    "probe_cheap_exp": [("expf(s[i][jj] - m_new);", "fmaf(s[i][jj] - m_new, 0.001f, 1.f);")],
    # S = Q K^T's loop over column blocks unrolled
    "qk_unrolled": [("#pragma unroll 1\n      for (int cb = 0;", "#pragma unroll\n      for (int cb = 0;")],
    # O += P V's loop over groups of 8 keys unrolled by 2
    "pv_unroll2": [("#pragma unroll 1\n      for (int g = 0;", "#pragma unroll 2\n      for (int g = 0;")],
    # the two block barriers of a kv tile replaced by each warp's own (a
    # warp's P holds its rows alone) and a count in shared memory whose
    # last arrival loads the next k or v tile
    "warp_arrivals": [
        ("  uint64_t* v_full = bars + 2;\n",
         "  uint64_t* v_full = bars + 2;\n"
         "  unsigned* done = reinterpret_cast<unsigned*>(bars + 3);\n"),
        ("      hw::mbar_init(v_full, 1);\n",
         "      hw::mbar_init(v_full, 1);\n      done[0] = done[1] = 0;\n"),
        (_K_SYNC + "      if (tid == 0 && j + 1 < n_tiles) {",
         "      __syncwarp();\n      if ((tid & 31) == 0 && j + 1 < n_tiles && last_warp(&done[0], j)) {"),
        (_V_SYNC + "      if (tid == 0 && j + 1 < n_tiles) {",
         "      __syncwarp();\n      if ((tid & 31) == 0 && j + 1 < n_tiles && last_warp(&done[1], j)) {"),
        ("template <int D>\n__global__ void __launch_bounds__(SM_THREADS, 2)",
         "__device__ __forceinline__ bool last_warp(unsigned* done, int j) {\n"
         "  __threadfence_block();\n"
         "  const bool last = atomicAdd(done, 1u) == 4u * j + 3u;\n"
         "  __threadfence_block();\n  return last;\n}\n\n"
         "template <int D>\n__global__ void __launch_bounds__(SM_THREADS, 2)"),
    ],
}
CHECKED = [(1, 1000, 1000, 24, 8, 128, 0), (2, 191, 191, 8, 2, 120, 0),
           (1, 250, 250, 4, 4, 112, 40, [201]), (1, 333, 333, 4, 4, 80, 100, [250])]
TIMED = [(1, 1000, 1000, 24, 8, 128, 0), (1, 2048, 2048, 24, 8, 128, 0),
         (1, 1000, 1000, 32, 32, 80, 0)]


def emit(**kw):
    line = json.dumps(kw)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def library(name: str) -> Path:
    return WORK / name / "flash_attention.so"


def build_all(names):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    jobs = []
    for name in names:
        d = WORK / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kbuild.CSRC, d / "csrc")
        text = (d / "csrc" / HEADER).read_text()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in {HEADER} once")
            text = text.replace(old, new)
        (d / "csrc" / HEADER).write_text(text)
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(library(name)),
               str(d / "csrc" / "flash_attention.cu")]
        jobs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    for name, proc in jobs:
        log = proc.communicate()[0]
        lines = log.splitlines()
        simt = [" ".join(x.strip() for x in lines[i + 2:i + 4]) for i, ln in enumerate(lines)
                if "Compiling entry function" in ln and "flash_fwd_simtILi128" in ln]
        emit(phase="build", variant=name, returncode=proc.returncode, ptxas_d128=simt[:1])
        if proc.returncode:
            raise SystemExit(log[-4000:])


def sass_mix(name: str):
    """Each loop (a backward branch spanning 32+ instructions) of the D 128
    instance with its instruction counts by opcode."""
    text = subprocess.run([CUOBJDUMP, "-sass", str(library(name))], capture_output=True,
                          text=True, check=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        fname, body = fn.split("\n", 1)
        if "flash_fwd_simtILi128" not in fname:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               (re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln) for ln in body.splitlines())
               if m]
        for addr, op in ins:
            jump = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
            if not jump or int(jump.group(1), 16) >= addr - 32 * 16:
                continue
            lo = int(jump.group(1), 16)
            mix = collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0]
                for a, o in ins if lo <= a <= addr)
            n = sum(mix.values())
            emit(phase="sass", variant=name, function=fname.strip()[:60], loop=[hex(lo), hex(addr)],
                 instructions=n, ffma_share=mix["FFMA"] / n, top=mix.most_common(8))


def run(name: str):
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ops as flash_ops
    path = library(name)
    kbuild.library_path = lambda _name: path
    kbuild.build = lambda _names: {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    for case in CHECKED:
        q, k, v, lens, window = cs.flash_inputs(case, torch.float32, gen)
        out = flash_ops.flash_attention(q, k, v, lens, window=window)
        ref = flash_ops.flash_attention_plain(q, k, v, lens, window=window)
        err = max(err, (out - ref).abs().max().item())
    if not name.startswith("probe_") and err > cs.TOL[torch.float32]:
        raise AssertionError(f"variant {name}: error {err} against the plain version")
    gen = torch.Generator(device="cuda").manual_seed(1)
    times = []
    for case in TIMED:
        q, k, v, lens, window = cs.flash_inputs(case, torch.float32, gen)
        fn = lambda: flash_ops.flash_attention(q, k, v, lens, window=window)  # noqa: E731
        times.append(min(cs.device_ms(fn, 20) for _ in range(3)))
    emit(phase="timing", variant=name, max_abs_err=err,
         shapes=[list(c[:6]) for c in TIMED], device_ms=times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--order", default="forward,backward",
                    help="passes over the variants: forward, backward, or both")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run(args.run)
        return
    names = args.variants.split(",")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text("")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(phase="device", nvidia_smi=smi.stdout.strip())
    build_all(names)
    if args.sass:
        sass_mix(names[0])
    for order in args.order.split(","):
        for name in names if order == "forward" else names[::-1]:
            subprocess.run([sys.executable, __file__, "--run", name], check=True, cwd=ROOT)


if __name__ == "__main__":
    main()
