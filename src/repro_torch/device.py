"""Device selection shared by every entry point of the port.

Entry points default to ``device="cuda"``. A CUDA device on a machine
without one raises: the port never falls back to the CPU on its own, the
caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in, so that
    "cuda" and "cuda:0" compare equal."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
