"""Architecture registry of the port: the models it can serve.

``get_config(arch_id)`` resolves a full-size config and
``get_smoke_config(arch_id)`` its family-preserving reduced form for CPU
tests. Only the dense serving path is ported, so only llama3.2-3b is here.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import llama3_2_3b
from repro_torch.configs.base import ModelConfig, reduced

ALL_MODELS: Dict[str, ModelConfig] = {llama3_2_3b.ARCH_ID: llama3_2_3b.CONFIG}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ALL_MODELS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_MODELS)}") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
