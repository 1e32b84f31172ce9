#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors: two ranks on ``cuda:0`` (the
way ``chip_smoke.py``'s sharded phases run), one pair of processes per op,
since an op that gloo does not take may abort its process.

    python3 tools/gloo_cuda_ops.py

Prints one JSON line per op: ``ok`` with each rank's result and seconds,
``error`` with the message, or ``crashed``; then the card's name and power
limit. ``repro_torch.parallel.collectives.GLOO_CUDA_OPS`` lists the ops
this found working; the others are staged through host memory there.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all_single",
       "broadcast_object_list", "batch_isend_irecv")


def _op(name, rank, world, dev):
    x = torch.full((4,), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(y := x.clone())
        return y.tolist()
    if name == "broadcast":
        dist.broadcast(y := x.clone(), src=0)
        return y.tolist()
    if name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [p.tolist() for p in parts]
    if name == "all_to_all_single":
        dist.all_to_all_single(y := torch.empty_like(x), x + torch.arange(4., device=dev))
        return y.tolist()
    if name == "broadcast_object_list":
        dist.broadcast_object_list(box := [{"rank": rank}], src=0)
        return box
    y = torch.empty_like(x)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, (rank + 1) % world),
        dist.P2POp(dist.irecv, y, (rank - 1) % world)])
    for w in works:
        w.wait()
    return y.tolist()


def rank_main(rank, name, out):
    t0 = time.perf_counter()
    try:
        result = dict(ok=_op(name, rank, dist.get_world_size(),
                             torch.device("cuda", 0)))
        torch.cuda.synchronize()
    except RuntimeError as e:
        result = dict(error=str(e)[:300])
    result["seconds"] = time.perf_counter() - t0
    Path(out, f"{name}.{rank}.json").write_text(json.dumps(result))


def main():
    from repro_torch.launch.mesh import run_ranks

    out = tempfile.mkdtemp(prefix="gloo_cuda_ops_")
    for name in OPS:
        try:
            run_ranks(rank_main, 2, (name, out), backend="gloo",
                      device_type="cuda")
            ranks = [json.loads(Path(out, f"{name}.{r}.json").read_text())
                     for r in range(2)]
            print(json.dumps({"op": name, "ranks": ranks}), flush=True)
        except Exception as e:  # a rank aborted: report it, try the next op
            print(json.dumps({"op": name, "crashed": repr(e)[:200]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__)


if __name__ == "__main__":
    main()
