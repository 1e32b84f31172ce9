"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so``
in the package's own directory, from a checkout or an installed copy
alike (``csrc`` is package data), and loaded with ``ctypes``; the hash
covers the source and the flags, so an edited source is rebuilt. ``build``
starts one ``nvcc`` per missing library, all at once, and waits for every
one of them.

Nothing here runs at import: the CPU tests import the wrappers and never
launch a kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# more flags for a library: the cluster designs' kernel instances compile
# in parallel (the cvt library's 20 in 23 s instead of 43 s on the card's
# host)
EXTRA_FLAGS = {"paged_attention_cvt": ("-split-compile=0",),
               "paged_attention_upcast": ("-split-compile=0",),
               "paged_attention_split": ("-split-compile=0",)}
# the ``dtype`` argument of every C entry
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the ``page_dtype`` argument of the entries that read pages of another
# dtype than q (``csrc/paged_cvt.cuh``; fp32 only in the upcast mode)
PAGE_CODES = {torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.int8: 3, torch.float32: 4}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    src = b"".join(p.read_bytes() for p in sources)
    flags = (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, in
    parallel. Returns the compiler's output (ptxas register and spill
    report) of each library it built."""
    jobs: List = []
    logs: Dict[str, str] = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, out))
        for name, proc, tmp, out in jobs:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{text}")
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(text)
            logs[name] = text
    finally:
        for _, proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


class CudaKernel:
    """One CUDA library's entry point, loaded at its first launch, and the
    number of times it was launched (``launches``, reset by the caller),
    also by the instance a wrapper names (``by_instance``)."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.by_instance = collections.Counter()
        self._lib = None
        self._fn = None

    def _load(self):
        if self._fn is None:
            build([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def reset(self):
        self.launches = 0
        self.by_instance.clear()

    def launch(self, *args, instance=None):
        """Call the C entry; it launches on the given stream and returns
        ``cudaGetLastError()``, which must be 0. ``instance`` names the
        kernel instance the call ran, for ``by_instance``."""
        err = self._load()(*args)
        if err != 0:
            msg = self._lib.error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err} ({msg})")
        self.launches += 1
        if instance is not None:
            self.by_instance[instance] += 1
