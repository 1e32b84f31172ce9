"""Meshes, as ``repro.launch.mesh``: functions, not module constants, so
importing this module touches no process group. ``make_mesh_for`` builds a
``DeviceMesh`` over the process group already initialised in this process
(``init_device_mesh`` would start one from the environment otherwise);
``make_production_mesh`` gives the reference's production meshes as
layout-only meshes, for the dry-run.

``run_ranks`` starts ``world`` processes, gives each its process group
(``tcp://127.0.0.1``, a free port) and calls ``fn(rank, *args)`` in each.
"""
from __future__ import annotations

import os
import socket
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, coords=()):
    """The reference's production mesh, 16x16 ("data", "model") or
    2x16x16 ("pod", "data", "model") with the batch over ("pod", "data"),
    as a layout-only ``AbstractMesh``: one rank of it, at ``coords``, is
    traced on meta tensors (``repro_torch.launch.dryrun``); no card runs it."""
    from repro_torch.parallel.sharding import AbstractMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes, tuple(coords))


def make_mesh_for(devices: int, model_parallel: int = 1, pods: int = 1, *,
                  device_type: str = "cuda"):
    """Elastic helper: lay the devices out as (pod, data, model)."""
    data = devices // (model_parallel * pods)
    if data * model_parallel * pods != devices:
        raise ValueError(f"{devices} devices don't tile (pods={pods}, "
                         f"tp={model_parallel})")
    if pods > 1:
        return _mesh(device_type, (pods, data, model_parallel),
                     ("pod", "data", "model"))
    return _mesh(device_type, (data, model_parallel), ("data", "model"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str,
               device_type: str, fn: Callable, args: Sequence):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              backend: str = "gloo", device_type: str = "cpu"):
    """``fn(rank, *args)`` in ``world`` spawned processes, each in a
    process group of ``backend``; ``fn`` must be importable by name.
    Raises if any rank fails. Each rank runs one CPU thread: the ranks
    share the host's cores."""
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(world, free_port(), backend, device_type,
                                 fn, tuple(args)))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
