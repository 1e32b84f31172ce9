"""The collectives of the reference's ``shard_map`` bodies, over one named
dimension of a ``DeviceMesh``: ``psum`` (``lax.psum``), a tiled
``all_gather`` along a tensor dimension, ``reduce_scatter`` (``lax.psum_scatter``
with ``tiled=True``: the sum over the ranks, this rank's slice of it along
a dimension), ``all_to_all`` (``lax.all_to_all`` with
``split_axis=concat_axis=0``), ``ppermute`` and ``axis_index``; and
``gather`` to coordinate 0, which a checkpoint's writer uses.

``psum``, ``all_gather``, ``reduce_scatter``, ``all_to_all`` and
``ppermute`` are ``torch.autograd.Function``s whose backward is their
transpose, as ``jax.grad`` takes it inside ``shard_map``: ``psum`` of the
cotangent; for the gather, the ``psum`` of the cotangent and then this
rank's slice of it (a reduce-scatter); for the reduce-scatter, the gather
of the cotangent; the inverse all-to-all, which is the all-to-all itself;
and ``ppermute`` by the inverse permutation. Under that transpose a rank's
gradient is its share of the sum over every rank's objective, so a value
that every rank of an axis computes alike enters the objective once per
rank (``Transformer``'s loss divides by the "model" size for that).

The group's backend chooses the transport, never a caught error. On NCCL
every op is the backend's own. Gloo takes CUDA tensors for ``all_reduce``,
``broadcast``, ``all_gather`` and ``all_to_all_single`` (``GLOO_CUDA_OPS``;
it copies them through the host itself), but its send and receive write
from the device pointer and abort the process (torch 2.11 on an H100). So
``ppermute`` of a CUDA tensor over a gloo group is staged through host
memory explicitly, and ``Comm.stats`` counts it. Two ranks on one card
(NCCL refuses that) run on gloo this way. Gloo has no reduce-scatter of
its own: there ``reduce_scatter`` is an ``all_reduce`` and this rank's
slice of it, booked as a ``reduce_scatter``.

``Comm.stats`` holds, per op, its calls, how many were staged, the bytes
it moved in and the host's seconds inside it (a gloo op returns when it is
done; an NCCL op when it is enqueued); an ``all_gather`` of weights (an
FSDP gather, ``all_gather(weights=True)``) also counts in ``weights``.

``CountingComm`` is the ``Comm`` of an ``AbstractMesh``: one rank of a
mesh traced alone, on meta tensors. Each op returns an empty tensor of its
result's shape and books, by the reference's kind (``all-reduce``,
``all-gather``, ``all-to-all``, ``collective-permute``), its call, its
payload (the operand's bytes, floats at 2 bytes as the reference counts
them), its group's size and its wire bytes by the reference's ring factors
(``src/repro/analysis/hlo.py``; a ``reduce_scatter`` is the kind
``reduce-scatter``, payload p and wire p(n-1)/n), into ``stats`` and into
the active op counter (``repro_torch.analysis.counter``); a gather of
weights also adds its wire to ``weight_wire``. The model code issues the same
collectives as on a real mesh; the transposes of training issue theirs.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import scopes

# ops gloo runs on CUDA tensors itself; the rest are staged through the host
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather", "all_to_all"})


class Comm:
    """Collectives over the named dimensions of ``mesh`` (None: one
    device, where every op is the identity on its group of one)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.stats: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------ layout
    def size(self, axis: str) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def reset(self):
        self.stats = {}

    # ------------------------------------------------------------ plumbing
    def _run(self, op: str, axis: str, x: torch.Tensor, fn, weights: bool = False):
        """``fn(group, x)`` on host copies where gloo does not take ``x``'s
        CUDA memory for ``op``; counted in ``stats``."""
        group = self.group(axis)
        staged = (x.is_cuda and dist.get_backend(group) == "gloo"
                  and op not in GLOO_CUDA_OPS)
        # lint: disable=REP002 (host time of a collective, not simulation)
        t0 = time.perf_counter()
        out = fn(group, x.cpu() if staged else x)
        if staged and out is not None:
            out = out.to(x.device)
        s = self.stats.setdefault(op, dict(calls=0, staged=0, bytes=0, seconds=0.0,
                                           weights=0))
        s["calls"] += 1
        s["staged"] += int(staged)
        s["weights"] += int(weights)
        s["bytes"] += x.numel() * x.element_size()
        # lint: disable=REP002 (host time of a collective, not simulation)
        s["seconds"] += time.perf_counter() - t0
        return out

    def _all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        def fn(group, t):
            t = t.clone()
            dist.all_reduce(t, group=group)
            return t
        return self._run("all_reduce", axis, x.contiguous(), fn)

    def _ppermute(self, x: torch.Tensor, axis: str,
                  perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        me = self.axis_index(axis)
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]

        def fn(group, t):
            out = torch.zeros_like(t)
            ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, d), group)
                   for d in dst]
            ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group)
                    for s in src]
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return out
        return self._run("ppermute", axis, x.contiguous(), fn)

    # ------------------------------------------------------------ ops
    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the ranks of ``axis`` (differentiable)."""
        if self.size(axis) == 1:
            return x
        return _PSum.apply(x, self, axis)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Send x from coordinate s to d for each (s, d) of ``perm``; a
        coordinate that receives nothing gets zeros (differentiable)."""
        if self.size(axis) == 1:
            return x if (0, 0) in perm else torch.zeros_like(x)
        return _PPermute.apply(x, self, axis, tuple(perm))

    def _all_gather(self, x: torch.Tensor, axis: str, dim: int,
                    weights: bool = False) -> torch.Tensor:
        n = self.size(axis)

        def fn(group, t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts, dim=dim)
        return self._run("all_gather", axis, x.contiguous(), fn, weights)

    def _reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n, me = self.size(axis), self.axis_index(axis)
        width = x.shape[dim] // n

        def fn(group, t):
            if dist.get_backend(group) == "gloo":
                t = t.clone()
                dist.all_reduce(t, group=group)
                return t.narrow(dim, me * width, width).contiguous()
            front = t.movedim(dim, 0).contiguous()
            out = front.new_empty((width, *front.shape[1:]))
            dist.reduce_scatter_tensor(out, front, group=group)
            return out.movedim(0, dim).contiguous()
        return self._run("reduce_scatter", axis, x.contiguous(), fn)

    def _all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        def fn(group, t):
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=group)
            return out
        return self._run("all_to_all", axis, x.contiguous(), fn)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int,
                   weights: bool = False) -> torch.Tensor:
        """The ranks' x concatenated along ``dim`` in coordinate order
        (``lax.all_gather(tiled=True)``; differentiable). ``weights``: x is
        a weight shard (an FSDP gather), counted apart in ``stats``."""
        if self.size(axis) == 1:
            return x
        return _AllGather.apply(x, self, axis, dim, weights)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum of the ranks' x, cut along ``dim`` into one slice per
        coordinate, of which this rank keeps its own
        (``lax.psum_scatter(tiled=True)``; differentiable). ``dim`` must
        divide over the axis."""
        n = self.size(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dimension {dim} of {tuple(x.shape)} "
                             f"does not divide over {axis} ({n})")
        return _ReduceScatter.apply(x, self, axis, dim)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x (n, ...): block i goes to coordinate i; the result's block j
        came from coordinate j (differentiable)."""
        if self.size(axis) == 1:
            return x
        return _AllToAll.apply(x, self, axis)

    def gather(self, x: torch.Tensor, axis: str, dim: int) -> Optional[torch.Tensor]:
        """The ranks' x concatenated along ``dim`` in coordinate order on
        coordinate 0 of ``axis``, None on the others (no gradient)."""
        n = self.size(axis)
        if n == 1:
            return x
        root = self.axis_index(axis) == 0

        def fn(group, t):
            parts = [torch.empty_like(t) for _ in range(n)] if root else None
            dist.gather(t, parts, dst=dist.get_global_rank(group, 0), group=group)
            return torch.cat(parts, dim=dim) if root else None
        return self._run("gather", axis, x.contiguous(), fn)

    def broadcast_object(self, obj, axis: Optional[str] = None, src: int = 0):
        """``obj`` of coordinate ``src`` on ``axis``, on every rank of it;
        with no axis, ``obj`` of the mesh's first rank on every rank of the
        mesh (which spans the process group)."""
        if axis is None:
            if self.mesh is None or self.mesh.mesh.numel() == 1:
                return obj
            group, root = None, int(self.mesh.mesh.flatten()[0])
        else:
            if self.size(axis) == 1:
                return obj
            group = self.group(axis)
            root = dist.get_global_rank(group, src)
        box: List[object] = [obj]
        # lint: disable=REP002 (host time of a collective, not simulation)
        t0 = time.perf_counter()
        dist.broadcast_object_list(box, src=root, group=group)
        s = self.stats.setdefault("broadcast_object",
                                  dict(calls=0, staged=0, bytes=0, seconds=0.0))
        s["calls"] += 1
        # lint: disable=REP002 (host time of a collective, not simulation)
        s["seconds"] += time.perf_counter() - t0
        return box[0]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_reduce(g, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim, weights):
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        ctx.width = x.shape[dim]
        return comm._all_gather(x, axis, dim, weights)

    @staticmethod
    def backward(ctx, g):
        me = ctx.comm.axis_index(ctx.axis)
        summed = ctx.comm._all_reduce(g, ctx.axis)
        return (summed.narrow(ctx.dim, me * ctx.width, ctx.width), None, None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        return comm._reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_gather(g, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._all_to_all(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_to_all(g, ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, perm):
        ctx.comm, ctx.axis, ctx.perm = comm, axis, perm
        return comm._ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return ctx.comm._ppermute(g, ctx.axis, inverse), None, None, None


# wire bytes a device moves per payload byte on a ring of n, as the
# reference's ``_RING_FACTOR``: an all-reduce is a reduce-scatter and an
# all-gather, 2(n-1)/n; an all-gather's operand is the local shard, so it
# receives n-1 of them; an all-to-all sends (n-1)/n of its buffer
RING_FACTOR = {"all-reduce": lambda n: 2 * (n - 1) / n,
               "all-gather": lambda n: float(n - 1),
               "reduce-scatter": lambda n: (n - 1) / n,
               "all-to-all": lambda n: (n - 1) / n,
               "collective-permute": lambda n: 1.0}


class CountingComm(Comm):
    """The collectives of an ``AbstractMesh``, counted and not run (the
    module docstring). ``stats[kind]`` holds calls, payload and wire bytes,
    the wire of weight gathers and the group sizes seen, and
    ``wire_by_axis`` the wire bytes over each mesh axis, at the scale of
    the loops around each call."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.wire_by_axis: Dict[str, float] = {}

    def reset(self):
        super().reset()
        self.wire_by_axis = {}

    def _count(self, kind: str, axis: str, x: torch.Tensor,
               out: torch.Tensor, weights: bool = False) -> torch.Tensor:
        n = self.size(axis)
        payload = scopes.strict_bytes(x)
        wire = payload * RING_FACTOR[kind](n)
        s = scopes.scale()
        entry = self.stats.setdefault(kind, dict(calls=0.0, payload=0.0, wire=0.0,
                                                 weight_wire=0.0, groups=[]))
        entry["calls"] += s
        entry["payload"] += payload * s
        entry["wire"] += wire * s
        entry["weight_wire"] += wire * s * weights
        self.wire_by_axis[axis] = self.wire_by_axis.get(axis, 0.0) + wire * s
        if n not in entry["groups"]:
            entry["groups"].append(n)
        scopes.book(hbm=payload + scopes.strict_bytes(out),
                    eager=(x.numel() + out.numel()) * x.element_size(),
                    collective=(kind, payload, wire))
        return out

    def _all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._count("all-reduce", axis, x, torch.empty_like(x))

    def _all_gather(self, x: torch.Tensor, axis: str, dim: int,
                    weights: bool = False) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] *= self.size(axis)
        return self._count("all-gather", axis, x, x.new_empty(shape), weights)

    def _reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        shape = list(x.shape)
        shape[dim] //= self.size(axis)
        return self._count("reduce-scatter", axis, x, x.new_empty(shape))

    def _all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self._count("all-to-all", axis, x, torch.empty_like(x))

    def _ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        return self._count("collective-permute", axis, x, torch.empty_like(x))
