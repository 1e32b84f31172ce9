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

``SHAPES`` are the reference's four input-shape cells and ``cells()`` its
(arch x shape) grid of the dry-run, with the long_500k skip rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.configs import (h2o_danube_3_4b, internvl2_76b,
                                  kimi_k2_1t, llama3_2_3b, llama3_405b,
                                  musicgen_medium, phi3_5_moe_42b, qwen3_14b,
                                  xlstm_350m, zamba2_2_7b)
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.paper_models import PAPER_MODELS

_SERVED = (llama3_2_3b, qwen3_14b, h2o_danube_3_4b, llama3_405b,
           internvl2_76b, musicgen_medium, phi3_5_moe_42b, kimi_k2_1t,
           zamba2_2_7b, xlstm_350m)

ARCHS: Dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _SERVED}
ALL_MODELS: Dict[str, ModelConfig] = {**ARCHS, **PAPER_MODELS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ALL_MODELS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALL_MODELS)}") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k requires sub-quadratic attention (brief); decoders have all
    other shapes. Returns (applicable, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch: long_500k skipped per brief (DESIGN.md §4)"
    return True, ""


def cells(include_skipped: bool = False) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (arch_id, shape_name, skip_reason|None) over the 40-cell grid."""
    for arch_id, cfg in ARCHS.items():
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            if ok:
                yield arch_id, shape.name, None
            elif include_skipped:
                yield arch_id, shape.name, why
