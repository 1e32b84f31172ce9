"""Architecture registry of the port: the models it can serve.

``get_config(arch_id)`` resolves a full-size config and
``get_smoke_config(arch_id)`` its family-preserving reduced form for CPU
tests. The port serves dense and MoE decoders with full (GQA) or latent
(MLA) attention: llama3.2-3b, phi3.5-moe and the paper's own models (the
DeepSeek-R1 distills and DeepSeek-R1-671B).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import llama3_2_3b, phi3_5_moe_42b
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.paper_models import PAPER_MODELS

ALL_MODELS: Dict[str, ModelConfig] = {
    llama3_2_3b.ARCH_ID: llama3_2_3b.CONFIG,
    phi3_5_moe_42b.ARCH_ID: phi3_5_moe_42b.CONFIG,
    **PAPER_MODELS,
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ALL_MODELS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_MODELS)}") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
