"""Per-device FLOPs, device-memory bytes and memory of one rank's step,
counted by a ``TorchDispatchMode`` over the step on meta tensors: the
port's counterpart of ``src/repro/analysis/hlo.py``, which parses the
reference's compiled HLO.

``OpCounter`` sees every aten op the step dispatches and books:

  * ``flops``: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    which ``matmul`` and ``einsum`` become) at 2*M*N*K, the reference's
    dot FLOPs; the kernels' products as their wrappers book them;
  * ``hbm_bytes``: the reference's strict op set (``_MEM_OPS`` and
    ``_mem_bytes`` of ``hlo.py``) in aten terms: a product's operands and
    result; an index, gather or embedding lookup at its result's bytes; an
    index_put, scatter or index_add/copy at its update's bytes (the cache
    write in place); a sort or top-k's operands and result; a copy into a
    view at the update's bytes (the reference's dynamic-update-slice);
    collective payloads and results; each kernel's own I/O. Floats count
    at 2 bytes (``scopes.FLOAT_BYTES``), as the reference counts them;
  * ``hbm_bytes_eager``: every op's operands and result at their true
    sizes, views and allocations aside: the traffic of the port's unfused
    eager step;
  * ``flash_scoped_bytes``: the strict bytes of attention's core (K1's I/O,
    and in training the plain attention under ``scope("flash_core")``),
    which the roofline replaces by the kernel's analytic I/O as the
    reference does;
  * collectives, booked by a counting ``Comm``
    (``repro_torch.parallel.collectives.CountingComm``) by kind: calls,
    payload and wire bytes;
  * ``peak_live_bytes``: the most bytes that storages allocated during the
    step held at once (arguments aside).

Loops that the model runs through ``scopes.Steps`` run their first
iteration, a middle one whose bookings count n - 2 times (``repeated``),
and their last. The backward of the middle one runs once too: each
autograd node made in the folded forward keeps the forward's multiplier,
and an op dispatched while that node runs
(``torch._C._current_autograd_node``) takes it. In the live bytes a
storage made in the folded iteration counts n - 2 times if autograd saved
it for the backward (a chunk's activations) or ``Steps.expand`` collected
it (a token's output); a carry counts once, as only one lives at a time. The peak is an estimate: a checkpointed
layer's input, which the checkpoint keeps outside autograd's hooks, counts
once.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.scopes import strict_bytes

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# the reference's gather and dynamic-slice: the bytes they read
_READS = {aten.index, aten.gather, aten.index_select, aten.embedding}
# the reference's scatter and dynamic-update-slice: the update's bytes,
# by the update's argument position
_WRITES = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
           aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
           aten.scatter_add_: 3, aten.index_add: 3, aten.index_add_: 3,
           aten.index_copy: 3, aten.index_copy_: 3}
_SORTS = {aten.sort, aten.topk}
# allocations: no traffic of their own
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _true_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _product_flops(packet, args) -> float:
    a, b = (args[0], args[1]) if packet in (aten.mm, aten.bmm) else (args[1], args[2])
    # (..., M, K) @ (..., K, N): 2 * batch * M * N * K
    return 2.0 * a.numel() * b.shape[-1]


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with OpCounter() as
    c:``). ``fold_loops`` lets ``scopes.Steps`` run three iterations of
    a loop and count the middle one n - 2 times."""

    counts_ops = True

    def __init__(self, fold_loops: bool = True):
        super().__init__()
        self.fold_loops = fold_loops
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.hbm_bytes_eager = 0.0
        self.scoped_bytes = 0.0
        self.flops_by_op: Dict[str, float] = defaultdict(float)
        self.coll_payload: Dict[str, float] = defaultdict(float)
        self.coll_wire: Dict[str, float] = defaultdict(float)
        self.coll_count: Dict[str, float] = defaultdict(float)
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self._scale = 1.0
        self._scopes: List[str] = []
        # autograd node of a folded forward op -> its multiplier
        self._node_scale: Dict[Any, float] = {}
        # the last op's outputs, whose grad_fn autograd sets after dispatch
        self._last: Tuple[List[torch.Tensor], float] = ([], 1.0)
        # storage id -> [bytes, multiplier, tensors alive on it, serial,
        # saved for the backward];
        # an id is an address, which a later storage may take again
        self._storages: Dict[int, List[float]] = {}
        self._serial = 0
        # (id, serial) of the storages made in each open ``repeated``
        # frame (the outermost: 0)
        self._frames: List[List[Tuple[int, int]]] = [[]]

    # ------------------------------------------------------------ scale
    def current_scale(self) -> float:
        node = torch._C._current_autograd_node()
        return self._scale * (self._node_scale.get(node, 1.0)
                              if node is not None else 1.0)

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Everything booked inside counts n times."""
        self._resolve_nodes()
        self._scale *= n
        self._frames.append([])
        try:
            yield
        finally:
            self._resolve_nodes()
            self._scale /= n
            for key, serial in self._frames.pop():
                entry = self._storages.get(key)
                if entry is not None and entry[3] == serial:   # it outlives the iteration
                    if entry[4]:
                        self._multiply(entry, n)
                    self._frames[-1].append((key, serial))

    def expanded(self, tensors, n: int):
        """``tensors``, one iteration's results, stand for n iterations'."""
        seen = set()
        for t in tensors:
            entry = self._storages.get(t.untyped_storage()._cdata)
            if entry is not None and entry[3] not in seen:
                seen.add(entry[3])
                self._multiply(entry, n)

    def _multiply(self, entry, n: int):
        self.live_bytes += entry[0] * entry[1] * (n - 1)
        entry[1] *= n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _saved(self, t: torch.Tensor) -> torch.Tensor:
        """Autograd's pack hook: mark the storage saved for the backward."""
        entry = self._storages.get(t.untyped_storage()._cdata)
        if entry is not None:
            entry[4] = True
        return t

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._saved, lambda t: t)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.__exit__(*exc)

    @contextlib.contextmanager
    def scope(self, name: str):
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()

    def _resolve_nodes(self):
        outs, s = self._last
        for t in outs:
            if t.grad_fn is not None:
                self._node_scale.setdefault(t.grad_fn, s)
        self._last = ([], 1.0)

    # ------------------------------------------------------------ booking
    def book(self, *, flops: float = 0.0, hbm: float = 0.0, eager: float = 0.0,
             scoped: bool = False, name: str = "", collective=None):
        """Add a cost at the current scale: ``flops``, strict ``hbm`` and
        ``eager`` bytes (``scoped``: attention's core); ``collective`` =
        (kind, payload bytes, wire bytes) adds one call of that kind."""
        s = self.current_scale()
        self.flops += flops * s
        if flops:
            self.flops_by_op[name] += flops * s
        self.hbm_bytes += hbm * s
        self.hbm_bytes_eager += eager * s
        if scoped or "flash_core" in self._scopes:
            self.scoped_bytes += hbm * s
        if collective is not None:
            kind, payload, wire = collective
            self.coll_payload[kind] += payload * s
            self.coll_wire[kind] += wire * s
            self.coll_count[kind] += s

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._resolve_nodes()
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
            # under inference mode a composite op (matmul, einsum) arrives
            # whole: count the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._track(func, outs)
        if self._scale != 1.0 and torch._C._current_autograd_node() is None:
            self._last = (outs, self._scale)
        if func.is_view or packet in _ALLOCS or packet is aten.detach:
            return out
        flops = hbm = 0.0
        if packet in _PRODUCTS:
            flops = _product_flops(packet, args)
            hbm = sum(strict_bytes(t) for t in ins + outs)
        elif packet in _READS:
            hbm = sum(strict_bytes(t) for t in outs)
        elif packet in _WRITES:
            hbm = strict_bytes(args[_WRITES[packet]])
        elif packet in _SORTS:
            hbm = sum(strict_bytes(t) for t in ins + outs)
        elif packet is aten.copy_ and args[0]._is_view():
            hbm = strict_bytes(args[1])
        self.book(flops=flops, hbm=hbm, eager=_true_bytes(ins) + _true_bytes(outs),
                  name=str(packet))
        return out

    # ------------------------------------------------------------ memory
    def _track(self, func, outs: List[torch.Tensor]):
        """Live bytes: a new storage is added when an op makes it and taken
        away when the last tensor on it dies."""
        fresh = [r.alias_info is None for r in func._schema.returns]
        if len(fresh) == 1:                 # one tensor, or a list of them
            fresh = fresh * len(outs)
        for i, t in enumerate(outs):
            key = t.untyped_storage()._cdata
            entry = self._storages.get(key)
            if entry is None:
                if not (i < len(fresh) and fresh[i]):
                    continue            # a view or in-place result of an argument
                self._serial += 1
                entry = [float(t.untyped_storage().nbytes()), 1.0, 0, self._serial,
                         False]
                self._storages[key] = entry
                self._frames[-1].append((key, self._serial))
                self.live_bytes += entry[0]
                self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            entry[2] += 1
            weakref.finalize(t, self._release, key, entry[3])

    def _release(self, key: int, serial: int):
        entry = self._storages.get(key)
        if entry is None or entry[3] != serial:
            return
        entry[2] -= 1
        if entry[2] <= 0:
            self.live_bytes -= entry[0] * entry[1]
            del self._storages[key]

    # ------------------------------------------------------------ results
    def summary(self) -> Dict[str, Any]:
        """The reference's ``Cost.summary()`` keys, plus the eager bytes,
        the FLOPs by op and the peak of live bytes."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_eager": self.hbm_bytes_eager,
            "flash_scoped_bytes": self.scoped_bytes,
            "flops_by_op": dict(self.flops_by_op),
            "collective_payload_bytes": dict(self.coll_payload),
            "collective_wire_bytes": dict(self.coll_wire),
            "collective_counts": dict(self.coll_count),
            "collective_payload_total": sum(self.coll_payload.values()),
            "collective_wire_total": sum(self.coll_wire.values()),
            "peak_live_bytes": self.peak_live_bytes,
        }


def tree_bytes(tree) -> int:
    """True bytes of the tensors in ``tree``, each leaf on its own (a
    folded loop's results repeat their one iteration's tensors)."""
    return _true_bytes(_tensors(tree))
