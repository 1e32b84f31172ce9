"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA H100s.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; ``BENCHMARK.json`` names the cells. The
port's kernel libraries build into the package's own directory in the
checkout at their first launch; every other build or kernel cache
directory is fixed inside the checkout too."""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
