"""What the model code, the kernel wrappers and the collectives tell an op
counter (``repro_torch.analysis.counter.OpCounter``), and nothing when none
is active.

The counter is a ``TorchDispatchMode``: it sees every aten op, but not the
structure around it. Three things come from the code instead:

  * ``Steps(n)`` iterates ``range(n)`` for a loop whose iterations cost
    alike (Mamba2's chunks, the xLSTM's tokens). Under a counter that
    folds loops it runs three: the first and the last count once, and the
    middle one, whose bookings forward and backward count n - 2 times,
    stands for every iteration that both reads a carry that needs a
    gradient and hands one on that the next iteration reads (so the
    backward runs through its carry both ways), as the reference's
    ``analysis/hlo.py`` multiplies a while body by its trip count.
    ``Steps.expand`` repeats the middle iteration's collected results n - 2
    times, so the shapes after the loop are the unfolded loop's. The layer
    stack is not looped here: the dry-run counts it by tracing two depths
    (``launch.dryrun.count_step``).
  * ``book`` takes the cost of work the counter cannot see as aten ops: a
    CUDA kernel's wrapper on a meta tensor books its kernel's operations
    and device-memory bytes, and a counting ``Comm`` its collectives.
  * ``scope(name)`` tags the ops inside it (``"flash_core"``: attention's
    scores, which the reference's roofline takes out of the memory term
    and replaces by the kernel's own I/O).

The active counter is found on PyTorch's dispatch-mode stack, so this
module keeps no state of its own.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

# bytes of a float element in the strict count: the reference's policy
# (``FLOAT_BYTES`` of ``src/repro/analysis/hlo.py``), its activations and
# weights in bf16 whatever the buffer's type
FLOAT_BYTES = 2


def strict_bytes(t: torch.Tensor) -> int:
    """``t``'s bytes with floats at ``FLOAT_BYTES`` each."""
    return t.numel() * (FLOAT_BYTES if t.is_floating_point() else t.element_size())


def active_counter():
    """The innermost active op counter, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_ops", False):
            return mode
    return None


def book(**cost):
    """Add ``cost`` (``OpCounter.book``'s keywords) to the active counter,
    scaled by the loops around it; nothing without one."""
    counter = active_counter()
    if counter is not None:
        counter.book(**cost)


def scale() -> float:
    """How many times the work being booked now runs: the product of the
    folded loops' trip counts around it (1 without a counter)."""
    counter = active_counter()
    return 1.0 if counter is None else counter.current_scale()


def scope(name: str):
    """Tag the ops inside with ``name`` (a no-op without a counter)."""
    counter = active_counter()
    return contextlib.nullcontext() if counter is None else counter.scope(name)


class Steps:
    """``range(n)``, or under a counter that folds loops, the first, one
    middle iteration counted n - 2 times, and the last."""

    def __init__(self, n: int):
        self.n = n
        counter = active_counter()
        self._counter = counter if counter is not None and counter.fold_loops \
            and n > 3 else None

    @property
    def folded(self) -> bool:
        return self._counter is not None

    def __iter__(self) -> Iterator[int]:
        if self._counter is None:
            yield from range(self.n)
            return
        yield 0
        with self._counter.repeated(self.n - 2):
            yield 1
        yield self.n - 1

    def expand(self, items: List) -> List:
        """The loop's results collected one per iteration, n of them."""
        if not self.folded:
            return items
        first, middle, last = items
        self._counter.expanded([t for t in tree_leaves(middle)
                                if isinstance(t, torch.Tensor)], self.n - 2)
        return [first] + [middle] * (self.n - 2) + [last]
