"""Checkpoints in the reference's format (``repro.train.checkpoint``),
written and read with numpy alone, so either package restores the
other's.

A checkpoint of step s is the directory ``<dir>/step-%09d`` holding
``arrays.npz`` (``a0``, ``a1``, ... in the tree's leaf order) and
``manifest.json`` (``{"step": s, "keys": [...]}``, each key the leaf's
path of dict keys and sequence indices joined by "/", as JAX's
``tree_flatten_with_path`` names it; dict keys sorted). numpy has no bf16,
so a bf16 leaf is stored as its two raw bytes (numpy ``V2``) and read back
through a 16-bit integer view, as the reference's bf16 arrays come out of
``np.load``.

* step-atomic: written to ``<dir>/tmp-<step>``, then renamed;
* async: ``save_async`` copies to the host on the caller's thread and
  writes on a worker thread, so the train loop keeps stepping (one
  device's tree);
* retention: keeps the newest ``keep`` checkpoints.

``restore`` puts the arrays on one ``device``.

Under a mesh (``placements=``, a tree of ``Placement``s like the tree,
and ``ctx=``) the tree's leaves are this rank's shards: ``save`` gathers
each leaf whole over the mesh axes it is cut over onto the rank at
coordinate 0 of every axis, one leaf at a time, and that rank writes it,
so the files are the single-device format; ``restore`` reads each whole array and keeps this
rank's slice, whatever mesh shape wrote it (elastic restore, the
reference's ``restore(shardings=)``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import entry_slices, mesh_axes, whole_shape
from repro_torch.train.tree import flatten_with_path, leaves, unflatten


def _keys_and_leaves(tree) -> Tuple[List[str], List[Any]]:
    flat = flatten_with_path(tree)
    return ["/".join(map(str, path)) for path, _ in flat], [v for _, v in flat]


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor leaf, bf16 as raw ``V2``."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_host(arr: np.ndarray, like, device) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if not (torch.is_tensor(like) and like.dtype == torch.bfloat16
                and arr.dtype.itemsize == 2):
            raise ValueError(f"raw {arr.dtype} array restored into a leaf "
                             "that is not a bf16 tensor")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def _write(keys: List[str], host: List[np.ndarray], directory: str,
           step: int, keep: int) -> str:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"tmp-{step}"
    final = d / f"step-{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **{f"a{i}": h for i, h in enumerate(host)})
    (tmp / "manifest.json").write_text(json.dumps({"step": step, "keys": keys}))
    os.replace(tmp, final)                       # atomic commit
    _gc(d, keep)
    return str(final)


def _gathered(leaf: torch.Tensor, place, ctx) -> Optional[torch.Tensor]:
    """A shard gathered whole onto the rank at coordinate 0 of every mesh
    axis, None on the others: a dimension cut over (a, b) is gathered over
    b, then a, each to coordinate 0. A rank off coordinate 0 of an axis on
    which the leaf is whole takes no part, nor do the other ranks of its
    groups, so no rank but the writer holds the whole leaf."""
    coords = ctx.coords()
    if any(coords[a] for a in ctx.axis_names if a not in place.axes()):
        return None
    with torch.no_grad():
        for dim, entry in enumerate(place.entries):
            for axis in reversed(mesh_axes(entry)):
                if leaf is None:
                    return None
                leaf = ctx.comm.gather(leaf, axis, dim)
    return leaf


def save(tree, directory: str, step: int, keep: int = 3, *,
         placements=None, ctx=None) -> str:
    """Write ``tree`` as the checkpoint of ``step``. Under a mesh every
    rank calls it; the rank at coordinate 0 of every axis writes and the
    others wait for it."""
    keys, vals = _keys_and_leaves(tree)
    if ctx is None or ctx.mesh is None:
        return _write(keys, [_to_host(v) for v in vals], directory, step, keep)
    host = []
    for v, place in zip(vals, leaves(placements)):
        whole = _gathered(v, place, ctx)
        if whole is not None:
            host.append(_to_host(whole))
        del whole
    writer = not any(ctx.coords().values())
    path = _write(keys, host, directory, step, keep) if writer else \
        str(Path(directory) / f"step-{step:09d}")
    dist.barrier()
    return path


def save_async(tree, directory: str, step: int, keep: int = 3
               ) -> threading.Thread:
    """Device->host copy now; the disk write on a worker thread, which the
    caller joins before the next save."""
    keys, vals = _keys_and_leaves(tree)
    host = [_to_host(v) for v in vals]
    t = threading.Thread(target=_write, args=(keys, host, directory, step, keep),
                         daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("-")[1]) for p in d.glob("step-*"))
    return steps[-1] if steps else None


def restore(like_tree, directory: str, step: Optional[int] = None,
            device=None, *, placements=None, ctx=None) -> Tuple[Any, int]:
    """The checkpoint of ``step`` (default: the latest) as a tree of
    ``like_tree``'s structure, its leaves torch tensors on ``device``
    (default: the CPU). Under a mesh each leaf is this rank's slice.
    Raises ``ValueError``
    unless the checkpoint's keys are ``like_tree``'s and each of its
    arrays (its slice, under a mesh) has the shape of ``like_tree``'s leaf
    where that leaf is a tensor: a tree padded for another tp does not
    restore."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    src = Path(directory) / f"step-{step:09d}"
    keys, likes = _keys_and_leaves(like_tree)
    manifest = json.loads((src / "manifest.json").read_text())
    if manifest["keys"] != keys:
        raise ValueError("checkpoint/model structure mismatch: "
                         f"{len(manifest['keys'])} keys in {src}, "
                         f"{len(keys)} in the tree")
    sharded = placements is not None and ctx is not None and ctx.mesh is not None
    places = leaves(placements) if sharded else [None] * len(likes)
    coords = ctx.coords() if sharded else None
    arrays = []
    with np.load(src / "arrays.npz") as data:
        for i, (like, place) in enumerate(zip(likes, places)):
            arr = data[f"a{i}"]
            if torch.is_tensor(like):
                want = tuple(like.shape) if place is None else \
                    whole_shape(like.shape, place.entries, ctx)
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"checkpoint/model structure mismatch: {keys[i]} is "
                        f"{tuple(arr.shape)} in {src}, {want} in the tree")
            if place is not None:
                # a C-ordered copy of the slice (a 0-d leaf stays 0-d)
                arr = np.array(arr[entry_slices(arr.shape, place.entries, ctx,
                                                coords)], order="C")
            arrays.append(_from_host(arr, like, device))
    return unflatten(like_tree, arrays), step


def training_placements(model):
    """The placements of a ``(model.param_tree(), opt_state)`` tree."""
    from repro_torch.train.optimizer import opt_state_placements
    params = model.placements()
    return params, opt_state_placements(params)


def save_training(model, opt_state, directory: str, step: int,
                  keep: int = 3) -> str:
    """``save`` of ``(model.param_tree(), opt_state)``, on one device or
    under the model's mesh."""
    return save((model.param_tree(), opt_state), directory, step, keep,
                placements=training_placements(model), ctx=model.ctx)


def restore_training(model, opt_state, directory: str,
                     step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore a ``(model.param_tree(), opt_state)`` checkpoint: the
    parameters are copied into ``model`` in place (under a mesh, this
    rank's shards of them, whatever mesh wrote it); returns the restored
    optimizer state, on the model's device, and its step."""
    (params, opt_state), step = restore(
        (model.param_tree(), opt_state), directory, step, device=model.device,
        placements=training_placements(model), ctx=model.ctx)
    with torch.no_grad():
        for p, saved in zip(leaves(model.param_tree()), leaves(params)):
            p.copy_(saved)
    return opt_state, step


def _gc(d: Path, keep: int):
    steps = sorted(d.glob("step-*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
