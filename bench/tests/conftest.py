"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of a checkout. They run on the CPU through the port's plain paths
at smoke sizes; those marked ``gpu`` need a card and skip without one."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
