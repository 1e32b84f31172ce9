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
  writes on a worker thread, so the train loop keeps stepping;
* retention: keeps the newest ``keep`` checkpoints.

``restore`` puts the arrays on one ``device``; re-sharding onto a mesh
waits for the multi-device slice.
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


def save(tree, directory: str, step: int, keep: int = 3) -> str:
    keys, vals = _keys_and_leaves(tree)
    return _write(keys, [_to_host(v) for v in vals], directory, step, keep)


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
            device=None) -> Tuple[Any, int]:
    """The checkpoint of ``step`` (default: the latest) as a tree of
    ``like_tree``'s structure, its leaves torch tensors on ``device``
    (default: the CPU). Raises ``ValueError`` unless the checkpoint's keys
    are ``like_tree``'s."""
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
    with np.load(src / "arrays.npz") as data:
        arrays = [_from_host(data[f"a{i}"], like, device)
                  for i, like in enumerate(likes)]
    return unflatten(like_tree, arrays), step


def restore_training(model, opt_state, directory: str,
                     step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore a ``(model.param_tree(), opt_state)`` checkpoint: the
    parameters are copied into ``model`` in place; returns the restored
    optimizer state, on the model's device, and its step."""
    (params, opt_state), step = restore((model.param_tree(), opt_state),
                                        directory, step, device=model.device)
    with torch.no_grad():
        for p, saved in zip(leaves(model.param_tree()), leaves(params)):
            p.copy_(saved)
    return opt_state, step


def _gc(d: Path, keep: int):
    steps = sorted(d.glob("step-*"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
