"""The weights, made from ``--seed`` on the device by the benchmark itself.

Every leaf of the decoder is named, shaped and scaled here from the
configuration's published sizes, as the port's parameters are laid out
(stacked layers under ``dense_stack`` or ``moe_stack``). A layer of a
leaf is one draw of a ``torch.Generator`` on the device seeded from
(seed, leaf, layer), in the served dtype: the program's parameters are
filled with these draws at set-up, and the plain reference draws any
layer again when it needs it, so it reads nothing the program holds."""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import torch

# leaf -> (shape, std of the normal draw, or None for a norm's ones)
Leaves = Dict[str, Tuple[Tuple[int, ...], Optional[float]]]


def layer_leaves(s) -> Leaves:
    """The leaves of one decoder layer, without the layer axis."""
    d, H, KV, D, ff = s["d"], s["H"], s["KV"], s["D"], s["ff"]
    out: Leaves = {
        "attn_norm": ((d,), None),
        "wq": ((d, H, D), d ** -0.5),
        "wk": ((d, KV, D), d ** -0.5),
        "wv": ((d, KV, D), d ** -0.5),
        "wo": ((H, D, d), (H * D) ** -0.5),
        "mlp_norm": ((d,), None),
    }
    if s["E"]:
        E = s["E"]
        out.update(router=((d, E), d ** -0.5), we_gate=((E, d, ff), d ** -0.5),
                   we_up=((E, d, ff), d ** -0.5), we_down=((E, ff, d), ff ** -0.5))
    else:
        out.update(w_gate=((d, ff), d ** -0.5), w_up=((d, ff), d ** -0.5),
                   w_down=((ff, d), ff ** -0.5))
    return out


def stack_name(s) -> str:
    return "moe_stack" if s["E"] else "dense_stack"


def model_leaves(s) -> Leaves:
    """Every leaf of the model, stacked layers with their layer axis."""
    d, V = s["d"], s["V"]
    out: Leaves = {"embed": ((V, d), d ** -0.5), "final_norm": ((d,), None)}
    if not s["tied"]:
        out["lm_head"] = ((d, V), d ** -0.5)
    for name, (shape, std) in layer_leaves(s).items():
        out[f"{stack_name(s)}.{name}"] = ((s["L"], *shape), std)
    return out


def _generator(seed: int, name: str, layer: int, device) -> torch.Generator:
    key = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(key[:8], "little"))


@torch.no_grad()
def draw(out: torch.Tensor, seed: int, name: str, layer: int, std: Optional[float]):
    """Fill ``out`` with layer ``layer`` of leaf ``name`` (layer 0 for an
    unstacked leaf)."""
    if std is None:
        out.fill_(1.0)
    else:
        out.normal_(0.0, std, generator=_generator(seed, name, layer, out.device))


def leaf(s, seed: int, name: str, layer: int = 0, *, device, dtype) -> torch.Tensor:
    """A fresh copy of one layer of a leaf (the whole leaf if unstacked)."""
    full = model_leaves(s)
    if name in full:
        shape, std = full[name]
        if name.partition(".")[2]:
            shape = shape[1:]
    else:
        shape, std = layer_leaves(s)[name]
        name = f"{stack_name(s)}.{name}"
    t = torch.empty(shape, dtype=dtype, device=device)
    draw(t, seed, name, layer, std)
    return t


def fill(params: Dict[str, torch.Tensor], s, seed: int):
    """Fill the program's parameters (``named_parameters()``) with the
    benchmark's draws; refuse a layout other than the one drawn here."""
    want = model_leaves(s)
    have = {n: tuple(p.shape) for n, p in params.items()}
    if have != {n: shape for n, (shape, _) in want.items()}:
        raise ValueError(f"the program's parameters {have} are not the "
                         f"benchmark's leaves {dict((n, v[0]) for n, v in want.items())}")
    for name, (shape, std) in want.items():
        p = params[name]
        if name.partition(".")[2]:
            for layer in range(shape[0]):
                draw(p[layer], seed, name, layer, std)
        else:
            draw(p, seed, name, 0, std)
