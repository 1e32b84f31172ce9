"""Weights between the JAX package's parameters and the port's model.

The JAX side is a nested dict of arrays, as
``repro.models.transformer.init_params(cfg, key, single_device_ctx(),
mode=...)`` returns it (any array type ``numpy.asarray`` accepts). On one
device the serve and train modes give the same names, shapes and arrays;
the layout is the model's (``Transformer(layout=)``), which decides only
how its GQA groups q heads.
``from_jax_params`` copies it into a ``Transformer`` (or, given a
``ParallelContext``, a tree built under a mesh into one rank's shard);
``to_jax_params``
gives it back as numpy. ``numpy_params`` makes such a dict from a numpy
seed, with the JAX package's layout and scales, where no JAX is at hand.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (Transformer, padded_shapes,
                                            param_axes, param_specs)
from repro_torch.parallel.sharding import ParallelContext, shard_slices


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return out


def from_jax_params(params: Mapping, cfg: ModelConfig, *, device="cuda",
                    dtype: torch.dtype = torch.float32,
                    layout: str = "serve", ctx: Optional[ParallelContext] = None,
                    coords: Optional[Dict[str, int]] = None) -> Transformer:
    """A ``Transformer`` in ``layout`` holding ``params``, cast to
    ``dtype``. With a ``ctx`` over a mesh, ``params`` is the reference's
    tree built under that mesh (``init_params(cfg, key, ctx,
    mode="serve")``: q heads padded to hp, kv heads tiled to kvp), and the
    model holds the shard of the rank at ``coords`` (default: this rank's
    coordinates on the mesh)."""
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    specs = param_specs(cfg)
    if set(flat) != set(specs):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(specs) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(specs))}")
    sharded = ctx is not None and ctx.mesh is not None
    shapes = padded_shapes(cfg, ctx) if sharded else \
        {n: shape for n, (shape, _, _) in specs.items()}
    for name, shape in shapes.items():
        if flat[name].shape != shape:
            raise ValueError(f"{name}: shape {flat[name].shape}, want {shape}")
    if sharded:
        coords = ctx.coords() if coords is None else coords
        axes = param_axes(cfg)
        flat = {n: a[shard_slices(a.shape, axes[n], ctx, coords)]
                for n, a in flat.items()}
    model = Transformer(cfg, device=device, dtype=dtype, seed=None,
                        layout=layout, ctx=ctx)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.require(flat[name], requirements="CW")))
    return model


def to_jax_params(model: Transformer) -> Dict[str, Any]:
    """The model's weights as the JAX package's nested dict of numpy arrays
    (fp32 for a bf16 model: numpy has no bf16)."""
    flat = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        flat[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _nest(flat)


def numpy_params(cfg: ModelConfig, seed: int,
                 dtype=np.float32) -> Dict[str, Any]:
    """Parameters (of either layout) drawn from ``numpy.random.default_rng(seed)``:
    normal with std 1/sqrt(fan_in), norms ones, the Mamba2 ``A_log`` and
    ``dt_bias`` zeros, in the JAX layout."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, (shape, init, fan_in) in param_specs(cfg).items():
        if init == "ones":
            flat[name] = np.ones(shape, dtype)
        elif init == "zeros":
            flat[name] = np.zeros(shape, dtype)
        else:
            w = rng.standard_normal(shape, dtype=np.float32)
            w /= math.sqrt(fan_in)
            flat[name] = w.astype(dtype, copy=False)
    return _nest(flat)
