"""Architecture registry of the port: the models it can serve.

``get_config(arch_id)`` resolves a full-size config and
``get_smoke_config(arch_id)`` its family-preserving reduced form for CPU
tests. The port serves dense and MoE decoders with full or sliding-window
(GQA, optionally with qk-norm) or latent (MLA) attention: llama3.2-3b,
qwen3-14b, h2o-danube-3-4b, llama3-405b, phi3.5-moe, kimi-k2 and the
paper's own models (the DeepSeek-R1 distills and DeepSeek-R1-671B); the
vlm internvl2-76b and the audio decoder musicgen-medium, whose backbones
are dense GQA/MHA decoders that take their frontend's embeddings as a
prefix; the hybrid zamba2-2.7b (Mamba2 layers and one shared attention
block); and the attention-free xlstm-350m (mLSTM and sLSTM blocks). It
holds every model of the JAX package's registry.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (h2o_danube_3_4b, internvl2_76b,
                                  kimi_k2_1t, llama3_2_3b, llama3_405b,
                                  musicgen_medium, phi3_5_moe_42b, qwen3_14b,
                                  xlstm_350m, zamba2_2_7b)
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.paper_models import PAPER_MODELS

_SERVED = (llama3_2_3b, qwen3_14b, h2o_danube_3_4b, llama3_405b,
           internvl2_76b, musicgen_medium, phi3_5_moe_42b, kimi_k2_1t,
           zamba2_2_7b, xlstm_350m)

ALL_MODELS: Dict[str, ModelConfig] = {
    **{m.ARCH_ID: m.CONFIG for m in _SERVED},
    **PAPER_MODELS,
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ALL_MODELS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_MODELS)}") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
