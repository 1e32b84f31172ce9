"""The dry-run of the port, as ``repro.launch.dryrun``: for every (arch x
shape) cell and production mesh, one rank's step is traced on the meta
device at full width under an op counter (``repro_torch.analysis.counter``)
and the per-device FLOPs, device-memory bytes, collectives, memory and
roofline terms are written to one JSON file per cell. Nothing is
allocated: a 16x16 or 2x16x16 mesh is a layout-only ``AbstractMesh`` whose
collectives are counted, not run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-2.7b \\
        --shape long_500k --mesh single --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape decode_32k --mesh 1x1 --batch 8 --measure

``--mesh 1x1`` counts one device holding the whole model; with
``--measure`` the same cell also runs on the card (seeded random weights
and caches) and its median step time is set beside the counted bound. A
cell cut to fit one card lists its cuts in ``reduced``.

The roofline uses one H100's constants (``core.perf_model.H100``) where
the reference uses v5e's; its analytic terms are the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.counter import OpCounter, tree_bytes
from repro_torch.configs.registry import SHAPES, cells, get_config, shape_applicable
from repro_torch.core.perf_model import H100
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_ctx, input_specs
from repro_torch.models.transformer import Transformer
from repro_torch.parallel.sharding import padded_heads
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (make_decode_step, make_prefill_step,
                                          make_train_step)

# one H100 SXM (per device): bf16 dense peak, HBM3, NVLink each way, and
# the network between 8-GPU NVLink domains
PEAK_FLOPS = H100.flops
HBM_BW = H100.hbm_bw
LINK_BW = H100.link_bw
INTER_BW = H100.inter_bw
NVLINK_DOMAIN = 8
MESHES = {"single": (16, 16), "multi": (2, 16, 16), "1x1": (1,)}


def lever_cells(lever: str) -> List[Tuple[str, str]]:
    """The (arch, shape) cells of the grid a §Perf lever is meant to move:
    ``serve_2d_tp``'s, ``decode_unroll``'s and ``kv_cache_dtype``'s every
    decode_32k cell; ``moe_ff_shard``'s the MoE models' decode_32k and
    prefill_32k; ``seq_shard_decode``'s the decode_32k cells with GQA or
    MLA attention; ``seq_parallel_norm``'s every prefill_32k cell;
    ``train_kv_2d``'s every train_4k cell."""
    out = []
    for arch, shape, skip in cells():
        cfg = get_config(arch)
        kind = SHAPES[shape].kind
        if lever == "moe_ff_shard":
            keep = cfg.family == "moe" and shape in ("decode_32k", "prefill_32k")
        elif lever == "seq_shard_decode":
            keep = shape == "decode_32k" and cfg.attention in ("full", "swa", "mla") \
                and cfg.family != "ssm"
        else:
            keep = {"seq_parallel_norm": "prefill", "train_kv_2d": "train"}.get(
                lever, "decode") == kind and shape != "long_500k"
        if keep:
            out.append((arch, shape))
    return out


def _shape(shape_name: str, batch: Optional[int]):
    """The cell's shape, its global batch cut to ``batch`` if given, and
    the cuts."""
    shape = SHAPES[shape_name]
    if batch is None or batch == shape.global_batch:
        return shape, {}
    return (dataclasses.replace(shape, global_batch=batch),
            {"global_batch": f"{shape.global_batch} -> {batch}"})


def _mesh(mesh: str):
    """The layout-only production mesh of a ``--mesh`` name (None: 1x1)."""
    return None if mesh == "1x1" else make_production_mesh(multi_pod=mesh == "multi")


def build_step(cfg, shape, mesh, multi_pod: bool, opts=None, device="meta",
               seed: Optional[int] = None
               ) -> Tuple[Transformer, Callable[[], Any], Dict[str, Any]]:
    """The rank's model of a cell over ``mesh`` (a layout-only mesh, or
    None), a closure that runs its step once, and the step's arguments: on
    ``device`` (meta: shapes only)."""
    ctx = build_ctx(mesh, multi_pod, cfg, shape, opts)
    layout = "train" if shape.kind == "train" else "serve"
    model = Transformer(cfg, device=device, dtype=torch.bfloat16, seed=seed,
                        layout=layout, ctx=ctx)
    spec = input_specs(cfg, shape, ctx, model, device=device)
    if shape.kind == "train":
        ocfg = AdamWConfig(state_dtype=torch.bfloat16 if (opts or {}).get("opt_bf16")
                           else torch.float32)
        opt_state = init_opt_state(model.param_tree(), ocfg)
        step = make_train_step(model, ocfg)
        return model, lambda: step(opt_state, spec), {"batch": spec, "opt": opt_state}
    if shape.kind == "prefill":
        step = make_prefill_step(model)
        return model, lambda: step(spec["tokens"], spec.get("prefix_embeds")), spec
    step = make_decode_step(model)
    return model, lambda: step(spec["tokens"], spec["positions"], spec["pools"],
                               spec["block_tables"], spec["states"], spec["rows"]), spec


def depth_variants(cfg):
    """The cell's model at a depth of one block of each kind, and for each
    kind the number of further blocks of it in ``cfg`` and a function of k
    giving the model with k more: a dense or MoE stack's layers; a
    hybrid's shared-block invocations and Mamba2 layers; an xLSTM's sLSTM
    and mLSTM blocks. A hybrid's or xLSTM's group of ``per`` blocks costs
    ``a + per * b``, so its kinds are the groups (with one Mamba2 layer or
    mLSTM block each) and the further ``per - 1`` blocks of every group."""
    def at(**kw):
        return dataclasses.replace(cfg, **kw)

    if cfg.family in ("hybrid", "ssm"):
        key = "attn_every" if cfg.family == "hybrid" else "slstm_every"
        every = getattr(cfg, key)
        one = 0 if cfg.family == "hybrid" else 1     # a group's sLSTM block
        groups, per = cfg.n_layers // every, every - one
        return at(n_layers=1 + one, **{key: 1 + one}), [
            (groups - 1, lambda k: at(n_layers=(1 + k) * (1 + one), **{key: 1 + one})),
            (groups * (per - 1), lambda k: at(n_layers=1 + k + one, **{key: 1 + k + one}))]
    if cfg.moe is not None and cfg.moe.n_experts:
        nd, nm = cfg.moe.first_dense_layers, cfg.n_layers - cfg.moe.first_dense_layers
        d1, m1 = min(nd, 1), min(nm, 1)

        def moe_at(d, m):
            return at(n_layers=d + m, moe=dataclasses.replace(cfg.moe, first_dense_layers=d))
        return moe_at(d1, m1), [(nd - 1, lambda k: moe_at(1 + k, m1)),
                                (nm - 1, lambda k: moe_at(d1, 1 + k))]
    return at(n_layers=1), [(cfg.n_layers - 1, lambda k: at(n_layers=1 + k))]


def _affine(base, deltas):
    """``base`` plus each (n, count) of ``deltas`` as n * (count - base),
    through nested dicts of numbers (a key one side lacks counts 0)."""
    if isinstance(base, dict) or any(isinstance(c, dict) for _, c in deltas):
        keys = set(base).union(*(c for _, c in deltas))
        return {k: _affine(base.get(k, 0.0), [(n, c.get(k, 0.0)) for n, c in deltas])
                for k in keys}
    return base + sum(n * (c - base) for n, c in deltas)


def _trace_step(cfg, shape, mesh, multi_pod: bool, opts=None) -> Dict[str, Any]:
    """One trace of the rank's step on meta: the counter's summary and
    ``memory``."""
    model, run, args = build_step(cfg, shape, mesh, multi_pod, opts)
    arg_bytes = tree_bytes((model.param_tree(), args))
    with OpCounter() as counter:
        out = run()
    res = counter.summary()
    comm = model.ctx.comm
    res["collective_weight_wire"] = sum(e.get("weight_wire", 0.0)
                                        for e in comm.stats.values())
    res["collective_wire_by_axis"] = dict(getattr(comm, "wire_by_axis", {}))
    res["memory"] = {"argument_bytes": arg_bytes, "output_bytes": tree_bytes(out),
                     "peak_live_bytes": counter.peak_live_bytes}
    return res


def count_step(cfg, shape, mesh, multi_pod: bool, opts=None) -> Dict[str, Any]:
    """One rank's step counted on meta tensors: the counter's summary and
    ``memory`` (the step's arguments: weights, inputs, caches, optimizer
    state; what it returns; the peak of what it allocates).

    The layer stack is counted as the reference's ``analyze`` scales a
    while body by its trip count: the step is traced with one block of
    each kind (``depth_variants``) and again with one more block of one
    kind, and the difference, that block's cost, counts once for every
    further block of its kind. Every count but the peak of live bytes is
    affine in the number of blocks of each kind, so this is exact. The
    peak, an estimate, is the largest traced at one more block, plus, for
    every further block of a kind, what a second one more added (a
    layer's saved activations or cache; nothing where the peak is one
    block's temporaries). Loops
    inside a layer (Mamba2's chunks, the xLSTM's tokens) are folded by the
    counter (``analysis.scopes.Steps``)."""
    # lint: disable=REP002 (measuring real trace wall time, not sim)
    t0 = time.perf_counter()

    def trace(c):
        return _trace_step(c, shape, mesh, multi_pod, opts)

    base, variants = depth_variants(cfg)
    res = trace(base)
    kinds = [(n, make, trace(make(1))) for n, make in variants if n > 0]
    peak = max([res["peak_live_bytes"]] + [r["peak_live_bytes"] for *_, r in kinds])
    for n, make, r in kinds:            # each further block's growth of the peak
        if n > 1:
            peak += (n - 1) * max(trace(make(2))["peak_live_bytes"]
                                  - r["peak_live_bytes"], 0.0)
    res = _affine(res, [(n, r) for n, _, r in kinds])
    res["peak_live_bytes"] = res["memory"]["peak_live_bytes"] = peak
    res["memory"]["peak_estimate_bytes"] = res["memory"]["argument_bytes"] + peak
    res["n_devices"] = 1 if mesh is None else mesh.size
    res["mesh_axes"] = {} if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape))
    # lint: disable=REP002 (measuring real trace wall time, not sim)
    res["trace_s"] = time.perf_counter() - t0
    return res


def count_cell(arch: str, shape_name: str, mesh: str = "single", opts=None,
               batch: Optional[int] = None) -> Dict[str, Any]:
    """The cell on a production mesh (``mesh``: single, multi or 1x1),
    counted (the reference's ``lower_cell``): ``count_step``'s result and
    ``roofline``; a cell the reference skips, its reason."""
    cfg = get_config(arch)
    shape, reduced = _shape(shape_name, batch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    res = count_step(cfg, shape, _mesh(mesh), mesh == "multi", opts)
    res.update({"arch": arch, "shape": shape_name,
                "mesh": "x".join(map(str, MESHES[mesh])),
                "opts": {k: str(v) for k, v in (opts or {}).items()}})
    if reduced:
        res["reduced"] = reduced
    res["roofline"] = roofline_terms(res, cfg, shape)
    return res


def axis_bandwidths(mesh_axes: Dict[str, int]) -> Dict[str, float]:
    """Each mesh axis's link rate: NVLink's where its ranks lie in one
    8-GPU NVLink domain (devices numbered with the last axis fastest, so
    an axis's ranks span its size times the sizes of the axes after it),
    the inter-node network's otherwise."""
    out, span = {}, 1
    for axis, size in reversed(list(mesh_axes.items())):
        span *= size
        out[axis] = LINK_BW if span <= NVLINK_DOMAIN else INTER_BW
    return out


def roofline_terms(res, cfg, shape):
    """The reference's ``roofline_terms`` on one H100's constants, and
    beside them ``t_collective_hier_s``: each axis's wire at its own link
    rate (``axis_bandwidths``), where ``t_collective_s`` puts all of it on
    NVLink as the reference's single link term does, and the bound and
    binding term with it."""
    flops = res["flops"]                      # per device (SPMD program)
    hbm = res["hbm_bytes"]
    wire = res["collective_wire_total"]
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm / HBM_BW
    t_coll = wire / LINK_BW
    bw = axis_bandwidths(res.get("mesh_axes", {}))
    by_axis = res.get("collective_wire_by_axis", {})
    t_coll_hier = sum(w / bw[a] for a, w in by_axis.items()) if by_axis else t_coll
    n_dev = res["n_devices"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens / n_dev

    # analytic fp32 optimizer streaming (outside the strict op set):
    # m read+write, v read+write (fp32) + bf16 param update write
    if shape.kind == "train":
        opt_stream = (4 * 4 + 2) * cfg.param_count() / n_dev
        hbm = hbm + opt_stream
        t_memory = hbm / HBM_BW
        res["hbm_bytes_with_opt"] = hbm

    # analytic must-move bytes per device (lower bound on HBM traffic)
    pbytes = cfg.param_count() * 2 / n_dev                  # bf16 weights
    if shape.kind == "train":
        # fwd+bwd weight reads, grad write, m/v read+write (fp32)
        must_bytes = 2 * pbytes + pbytes + 4 * (cfg.param_count() * 4 / n_dev)
    elif shape.kind == "decode":
        cache = (cfg.kv_bytes_per_token(2) * shape.seq_len
                 + cfg.state_bytes_per_seq(2)) * shape.global_batch / n_dev
        must_bytes = cfg.active_param_count() * 2 / n_dev + cache
    else:  # prefill: read weights, write the cache once
        cache = cfg.kv_bytes_per_token(2) * tokens / n_dev
        must_bytes = pbytes + cache
    # kernel-adjusted memory term: attention's core (K1's I/O, the plain
    # training attention's scores) out, the kernel's analytic I/O (q,k,v
    # read + o write) in
    hp, kvp = padded_heads(cfg.n_heads, cfg.n_kv_heads, 16)
    kvx = kvp if shape.kind != "train" else (
        cfg.n_kv_heads if hp % cfg.n_kv_heads == 0 else kvp)
    hd = cfg.resolved_head_dim
    passes = 4 if shape.kind == "train" else 1
    if shape.kind != "decode" and cfg.n_attention_layers:
        io = (2 * hp * hd + 2 * kvx * hd) * tokens * 2 \
            * cfg.n_attention_layers * passes / n_dev
    else:
        io = 0.0
    hbm_kernel = max(hbm - res.get("flash_scoped_bytes", 0.0) + io, 0.0)
    t_memory_kernel = hbm_kernel / HBM_BW

    dom = max((t_compute, "compute"), (t_memory, "memory"), (t_coll, "collective"))
    eff = {"compute": (model_flops / flops) if flops else 0.0,
           "memory": (must_bytes / hbm) if hbm else 0.0,
           "collective": (res["collective_payload_total"] / wire) if wire else 1.0}
    return {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_memory_kernel_adj_s": t_memory_kernel,
        "hbm_bytes_kernel_adj": hbm_kernel,
        "bottleneck": dom[1],
        "model_flops_per_dev": model_flops,
        "must_bytes_per_dev": must_bytes,
        "useful_flop_ratio": (model_flops / flops) if flops else 0.0,
        "memory_efficiency": eff["memory"],
        "dominant_efficiency": eff[dom[1]],
        # MFU the step would achieve if it ran exactly at the binding roofline
        "roofline_fraction": (model_flops / PEAK_FLOPS) / max(
            t_compute, t_memory, t_coll) if flops else 0.0,
        "step_time_bound_s": max(t_compute, t_memory, t_coll),
        "t_collective_hier_s": t_coll_hier,
        "step_time_bound_hier_s": max(t_compute, t_memory, t_coll_hier),
        "bottleneck_hier": max((t_compute, "compute"), (t_memory, "memory"),
                               (t_coll_hier, "collective"))[1],
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
                      "inter_bw": INTER_BW, "hardware": H100.name},
    }


def measure_cell(arch: str, shape_name: str, batch: Optional[int] = None,
                 opts=None, warmup: int = 2, iters: int = 5, seed: int = 0
                 ) -> Dict[str, Any]:
    """The cell at mesh 1x1 on the card: seeded random weights, tokens and
    caches (normal, std 0.5), its step run ``warmup`` times and then timed
    ``iters`` times by CUDA events; the median beside the count
    (``count_cell``) and its bound. Raises without a card."""
    res = count_cell(arch, shape_name, "1x1", opts, batch)
    if "skipped" in res:
        return res
    shape, _ = _shape(shape_name, batch)
    model, run, args = build_step(get_config(arch), shape, None, False, opts,
                                  device="cuda", seed=seed)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    inputs = args.get("batch", args)            # a train step's are its batch
    with torch.no_grad():
        for key in ("tokens", "labels"):
            if key in inputs:
                inputs[key].copy_(torch.randint(0, model.cfg.vocab, inputs[key].shape,
                                                generator=gen, device=model.device))
        for t in [inputs.get("prefix_embeds"), *args.get("pools", ())]:
            if t is not None:
                t.normal_(0.0, 0.5, generator=gen)
        for t in args.get("states", ()):
            t.zero_()
    times = []
    for i in range(warmup + iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end) / 1e3)
    times.sort()
    res["measured"] = {
        "step_s": times[len(times) // 2], "steps_s": times,
        "device": torch.cuda.get_device_name(0),
        "share_of_bound": res["roofline"]["step_time_bound_s"] / times[len(times) // 2],
        "finite": bool(all(torch.isfinite(t.float()).all() for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))),
    }
    return res


def _status(res: Dict[str, Any]) -> str:
    if "error" in res:
        return "ERROR " + res["error"][:120]
    if "skipped" in res:
        return "skipped: " + res["skipped"]
    return (f"ok flops={res['flops']:.3e} hbm={res['hbm_bytes']:.3e} "
            f"wire={res['collective_wire_total']:.3e} "
            f"bottleneck={res['roofline']['bottleneck']} "
            f"frac={res['roofline']['roofline_fraction']:.3f} "
            f"trace={res['trace_s']:.1f}s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both", "1x1"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--opts", default="{}",
                    help='json, e.g. {"opt_bf16": true, "remat": "none"}')
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the global batch (listed in the cell's reduced)")
    ap.add_argument("--measure", action="store_true",
                    help="with --mesh 1x1: also run the cell on the card")
    args = ap.parse_args()
    if args.measure and args.mesh != "1x1":
        ap.error("--measure runs a cell on one card: it needs --mesh 1x1")
    opts = json.loads(args.opts)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        todo = [(a, s) for a, s, skip in cells(include_skipped=True)
                if skip is None]
    else:
        todo = [(args.arch, args.shape)]
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])

    for arch, shape in todo:
        for mesh in meshes:
            name = f"{arch}__{shape}__{mesh}__{args.tag}"
            path = outdir / f"{name}.json"
            if path.exists() and not args.force:
                print(f"[skip existing] {name}", flush=True)
                continue
            print(f"[dryrun] {name} ...", flush=True)
            try:
                res = (measure_cell(arch, shape, args.batch, opts) if args.measure
                       else count_cell(arch, shape, mesh, opts, args.batch))
            except Exception as e:  # record failures for triage
                res = {"arch": arch, "shape": shape, "mesh": mesh,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-4000:]}
            path.write_text(json.dumps(res, indent=1, default=str))
            print(f"[done] {name}: {_status(res)}", flush=True)


if __name__ == "__main__":
    main()
