"""Logical-axis sharding, as ``repro.parallel.sharding``: every parameter
and activation carries logical axis names; a rule table maps them onto the
named dimensions of a ``torch.distributed.device_mesh.DeviceMesh``.

Baseline rules (the reference's):
  * weights: FSDP over "data" on the d_model/d_ff contracting axes, TP over
    "model" on heads / mlp / experts / vocab;
  * activations: batch over ("pod","data");
  * multi-pod: params replicated across "pod", batch also over "pod".

The reference hands the rules to GSPMD. The port holds each parameter as
this rank's shard (``shard_shape``, ``shard_slices``) and its model code
issues the collectives itself (``repro_torch.parallel.collectives``).

Head padding: TP needs the (q-)head axis divisible by the model-axis size.
``padded_heads`` gives (hp, kvp) with hp % tp == 0, kvp % tp == 0,
hp % kvp == 0 and (GQA) kvp % n_kv == 0. Padded q-head slots are zero
(inert); padded kv slots are tiled copies of their original head (exact
math; the serve layout).

``AbstractMesh`` stands in for a ``DeviceMesh`` where only the layout
matters, as ``jax.sharding.AbstractMesh`` does for the reference: layouts
and shard shapes without a process group, and one rank of a mesh of any
size traced on meta tensors (its coordinates given), whose collectives a
``CountingComm`` counts instead of running.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

PERF_LEVERS = ("decode_unroll", "serve_2d_tp", "seq_parallel_norm",
               "moe_ff_shard", "seq_shard_decode", "train_kv_2d")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and dimension names, without devices or groups, and
    the coordinates of the rank it stands for (all 0 if not given)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    coords: Tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def get_local_rank(self, axis: str) -> int:
        return self.coords[self.mesh_dim_names.index(axis)] if self.coords else 0


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """Everything model code needs to know about the device layout.
    ``mesh`` is a ``DeviceMesh`` (or an ``AbstractMesh``) whose dimension
    names include ``batch_axes`` and ``model_axis``; None is one device."""
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") for multi-pod
    model_axis: str = "model"
    fsdp_axis: Optional[str] = "data"         # None -> replicate weights over data
    remat: str = "none"                       # none | full
    kv_cache_dtype: Any = None                # default: the model's dtype
    moe_dispatch: str = "auto"                # auto | split | replicated
    rules_override: Optional[Dict[str, Any]] = None
    # ---- the reference's §Perf levers; rules() follows them, the model
    # refuses any that is set (ROADMAP §1) ----
    decode_unroll: bool = False
    serve_2d_tp: bool = False
    seq_parallel_norm: bool = False
    moe_ff_shard: bool = False
    seq_shard_decode: bool = False
    train_kv_2d: bool = False

    def axis_size(self, axis: str) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's dimensions (none without a mesh)."""
        return () if self.mesh is None else tuple(self.mesh.mesh_dim_names)

    @property
    def tp(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def dp(self) -> int:
        return int(np.prod([self.axis_size(a) for a in self.batch_axes]))

    def rules(self) -> Dict[str, Any]:
        r = dict(DEFAULT_RULES)
        r["batch"] = self.batch_axes if len(self.batch_axes) > 1 else self.batch_axes[0]
        if self.fsdp_axis is None:
            for k in ("embed", "mlp_in", "expert_in"):
                r[k] = None
        else:
            r["embed"] = self.fsdp_axis
        if self.serve_2d_tp:
            r["act_d"] = self.fsdp_axis or "data"
        if self.seq_parallel_norm:
            r["act_seq"] = self.model_axis
        if self.moe_ff_shard:
            r["expert_ff"] = self.fsdp_axis or "data"
        r["embed_kv"] = ((self.fsdp_axis or "data", self.model_axis)
                         if self.train_kv_2d else r["embed"])
        if self.seq_shard_decode:
            r["cache_seq"] = self.model_axis
            r["cache_kv"] = None
        if self.rules_override:
            r.update(self.rules_override)
        return r

    def spec(self, *logical_axes: Optional[str]) -> Tuple[Any, ...]:
        """The mesh axes of each logical axis, as the entries of the
        reference's ``PartitionSpec``: a name, a tuple of names or None."""
        rules = self.rules()
        return tuple(rules.get(a) if a is not None else None for a in logical_axes)

    def levers_set(self) -> Tuple[str, ...]:
        """The §Perf levers set to other than their defaults."""
        return tuple(n for n in PERF_LEVERS if getattr(self, n)) + (
            ("remat",) if self.remat != "none" else ())

    @functools.cached_property
    def comm(self):
        """The collectives over this context's mesh (one device mesh, one
        ``Comm``: its counters sum every op the model issues); over an
        ``AbstractMesh`` a ``CountingComm``, which books them unrun."""
        from repro_torch.parallel.collectives import Comm, CountingComm
        return (CountingComm if isinstance(self.mesh, AbstractMesh) else Comm)(self.mesh)

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each mesh dimension."""
        return {a: self.mesh.get_local_rank(a) for a in self.axis_names}


# logical axis -> mesh axis (None = replicated)
DEFAULT_RULES: Dict[str, Any] = {
    "batch": "data",
    "seq": None,
    "embed": "data",        # FSDP: weight d_model axis
    "vocab": "model",       # embedding table vocab axis (TP)
    "heads": "model",       # padded q-head axis
    "kv_heads": "model",    # padded kv-head axis (serve layout)
    "kv_heads_exact": None, # unpadded kv heads (train layout: replicated acts)
    "d_tp": "model",        # untied embedding-table d_model axis (TP)
    "head_dim": None,
    "mlp": "model",         # d_ff axis
    "mlp_in": "data",       # FSDP on the w_down d_ff input axis
    "expert": "model",      # expert-parallel axis
    "expert_in": "data",    # FSDP inside each expert's d_model axis
    "expert_ff": None,      # §Perf moe_ff_shard flips this to "data"
    "layers": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_ch": "model",
    "lstm_vdim": "model",   # mLSTM value head_dim sharding
    "mla_rank": None,
    "cache_batch": "data",
    "cache_seq": None,      # §Perf flips this to "data"/"model" for seq-sharded KV
    "cache_kv": "model",
    "act_d": None,          # §Perf serve_2d_tp: activation d_model axis
    "act_seq": None,        # §Perf seq_parallel_norm: residual seq axis
    "embed_kv": "data",     # kv-proj d_model axis (train_kv_2d -> 2D tuple)
}


def single_device_ctx() -> ParallelContext:
    return ParallelContext(mesh=None)


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A (data, model) ``DeviceMesh`` over the initialised process group."""
    from repro_torch.launch.mesh import make_mesh_for
    return make_mesh_for(data * model, model_parallel=model,
                         device_type=device_type)


def padded_heads(n_heads: int, n_kv: int, tp: int) -> Tuple[int, int]:
    """(hp, kvp): padded q/kv head counts for a TP degree (see module doc)."""
    if tp <= 1:
        return n_heads, n_kv
    hp = -(-n_heads // tp) * tp
    if n_kv >= n_heads:                      # MHA: 1:1, zero-pad both
        return hp, hp
    kvp = tp
    while not (hp % kvp == 0 and kvp % n_kv == 0 and kvp >= n_kv):
        kvp += tp
        if kvp > hp:                         # fall back: widen hp to lcm
            hp = abs(hp * n_kv) // math.gcd(hp, n_kv)
            hp = -(-hp // tp) * tp
            kvp = tp
    return hp, kvp


def q_to_orig(hp: int, kvp: int, n_heads: int, n_kv: int) -> np.ndarray:
    """Map padded q slot -> original q head (or -1 for inert pad slots).
    Padded q slots are grouped contiguously by padded kv slot (hp//kvp per
    slot); padded kv slot s replicates original kv head s // (kvp//n_kv)
    (identity + zero-pad in the MHA case). Original q heads of kv group k
    are distributed over that group's replica slots in order."""
    out = -np.ones(hp, dtype=np.int64)
    gp = hp // kvp
    if n_kv >= n_heads:                      # MHA identity
        out[:n_heads] = np.arange(n_heads)
        return out
    r = kvp // n_kv
    g = n_heads // n_kv
    for k in range(n_kv):
        orig = list(range(k * g, (k + 1) * g))
        slots = [s * gp + j for s in range(k * r, (k + 1) * r) for j in range(gp)]
        for slot, oq in zip(slots, orig):
            out[slot] = oq
    return out


def kv_to_orig(kvp: int, n_heads: int, n_kv: int) -> np.ndarray:
    """Map padded kv slot -> original kv head (or -1 for zero-pad in MHA)."""
    out = -np.ones(kvp, dtype=np.int64)
    if n_kv >= n_heads:
        out[:n_kv] = np.arange(n_kv)
        return out
    r = kvp // n_kv
    out[:] = np.arange(kvp) // r
    return out


# ------------------------------------------------------------ rank shards
def mesh_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _parts(ctx: ParallelContext, entry) -> int:
    """How many shards a dimension mapped to spec ``entry`` is cut into."""
    return int(np.prod([ctx.axis_size(a) for a in mesh_axes(entry)]))


def _index(ctx: ParallelContext, entry, coords: Dict[str, int]) -> int:
    """Which of those shards a rank at ``coords`` holds: its coordinates on
    the entry's mesh axes, flattened major to minor."""
    i = 0
    for a in mesh_axes(entry):
        i = i * ctx.axis_size(a) + coords.get(a, 0)
    return i


def shard_shape(shape: Sequence[int], axes: Sequence[Optional[str]],
                ctx: ParallelContext) -> Tuple[int, ...]:
    """A rank's shard of a leaf of ``shape`` with logical ``axes``; raises
    where a dimension does not divide its mesh axes."""
    out = []
    for n, entry in zip(shape, ctx.spec(*axes)):
        parts = _parts(ctx, entry)
        if n % parts:
            raise ValueError(f"dimension {n} of {tuple(shape)} {tuple(axes)} "
                             f"does not divide over {entry} ({parts})")
        out.append(n // parts)
    return tuple(out)


def shard_slices(shape: Sequence[int], axes: Sequence[Optional[str]],
                 ctx: ParallelContext, coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of the rank at ``coords`` into the whole leaf."""
    return entry_slices(shape, ctx.spec(*axes), ctx, coords)


def entry_slices(shape: Sequence[int], entries: Sequence[Any],
                 ctx: ParallelContext, coords: Dict[str, int]) -> Tuple[slice, ...]:
    """``shard_slices`` for a leaf given by its spec entries (mesh axes)."""
    out = []
    for n, e in zip(shape, entries):
        parts = _parts(ctx, e)
        if n % parts:
            raise ValueError(f"dimension {n} of {tuple(shape)} does not divide "
                             f"over {e} ({parts})")
        m = n // parts
        out.append(slice(_index(ctx, e, coords) * m, (_index(ctx, e, coords) + 1) * m))
    return tuple(out)


def whole_shape(local: Sequence[int], entries: Sequence[Any],
                ctx: ParallelContext) -> Tuple[int, ...]:
    """The whole leaf's shape of a rank's shard of shape ``local``."""
    return tuple(n * _parts(ctx, e) for n, e in zip(local, entries))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives on the mesh: one spec entry per dimension (a mesh
    axis, a tuple of them or None), the reference's ``PartitionSpec``. A
    leaf of a tree (``repro_torch.train.tree`` walks into tuples, not into
    this)."""
    entries: Tuple[Any, ...] = ()

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the leaf is cut over, in its dimensions' order."""
        return tuple(a for e in self.entries for a in mesh_axes(e))
