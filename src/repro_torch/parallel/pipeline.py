"""Pipeline parallelism, as ``repro.parallel.pipeline``: the GPipe tick
schedule over the ranks of one mesh dimension.

Layers are grouped into ``n_stages`` stages; stage s runs on coordinate s
of ``stage_axis``. Micro-batches stream through by ``ppermute``; the
schedule runs ``n_micro + n_stages - 1`` ticks, and every stage computes
on every tick under a validity mask, so the bubbles run masked work (the
bubble fraction (p-1)/(m+p-1)). The last stage records each finished
micro-batch, and a final ``psum`` over the stages hands its outputs to
every rank.

Differentiable end to end: ``ppermute`` and ``psum`` carry their
transposes (``repro_torch.parallel.collectives``), and the output, the
same on every stage, returns the cotangent to the stages once, as the
reference's unmapped ``shard_map`` output does (its cotangent is divided
by the axis size before the ``psum`` transpose adds it back).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.collectives import Comm


class _Replicated(torch.autograd.Function):
    """The boundary of an output that every rank of ``n`` holds alike:
    identity forward, the cotangent over n backward."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def pipeline_forward(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                     mesh, n_micro: int, stage_axis: str = "stage"):
    """x (B, ...) split into ``n_micro`` micro-batches along axis 0, the
    same x on every rank. ``stage_fn(stage_params, micro_x) -> micro_y``;
    ``stage_params`` are this rank's stage's parameters (the reference's
    ``params_stacked[s]`` on stage s). Returns y (B, ...) =
    stage_{p-1}(... stage_0(x)) on every rank."""
    comm = Comm(mesh)
    n_stages = comm.size(stage_axis)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} % n_micro {n_micro}")
    mb = B // n_micro
    s = comm.axis_index(stage_axis)
    micros = x.reshape(n_micro, mb, *x.shape[1:])
    carry = torch.zeros_like(stage_fn(stage_params, micros[0]))
    outs = [torch.zeros_like(carry) for _ in range(n_micro)]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    # the masks are tensors, as the reference's jnp.where, so that every
    # rank builds the same graph: its backward then runs every ppermute's
    # transpose on every rank, in the same order
    flag = lambda b: torch.tensor(bool(b), device=x.device)  # noqa: E731
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests micro-batch t (if in range); the others take the
        # permuted output of their predecessor
        feed = micros[min(t, n_micro - 1)] if t < n_micro \
            else torch.zeros_like(micros[0])
        inp = torch.where(flag(s == 0), feed.to(carry.dtype), carry)
        out = stage_fn(stage_params, inp)
        # valid iff this stage is processing micro-batch t - s
        valid = 0 <= t - s < n_micro
        out = torch.where(flag(valid), out, torch.zeros_like(out))
        # the last stage records its finished micro-batch
        mi = min(max(t - (n_stages - 1), 0), n_micro - 1)
        outs[mi] = torch.where(flag(s == n_stages - 1 and valid), out, outs[mi])
        carry = comm.ppermute(out, stage_axis, perm)
    # only the last stage holds real outputs; the psum hands them to all
    stacked = torch.stack(outs)
    y = comm.psum(torch.where(flag(s == n_stages - 1), stacked,
                              torch.zeros_like(stacked)), stage_axis)
    return _Replicated.apply(y, n_stages).reshape(B, *y.shape[2:])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
