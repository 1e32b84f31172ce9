"""The system under test: the port's ``InferenceEngine`` in real-clock
mode over a ``TorchRunner`` on its ``Transformer``, built as
``repro_torch.launch.serve.build_engine`` builds it, with the
configuration file's ``EngineConfig`` and the benchmark's own weights.
This is the only module of the benchmark that imports the program."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.request import Request
from repro_torch.core.runner import TorchRunner
from repro_torch.models.transformer import Transformer

from harness import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

__all__ = ["Request", "build", "model_config", "engine_config"]


def model_config(config: Dict, s: Dict) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file."""
    port = config.get("port", {})
    moe = None
    if s["E"]:
        moe = MoEConfig(n_experts=s["E"], top_k=s["top_k"], d_ff_expert=s["ff"],
                        capacity_factor=float(port["capacity_factor"]))
    return ModelConfig(
        name=config["name"], family="moe" if s["E"] else "dense",
        n_layers=s["L"], d_model=s["d"], n_heads=s["H"], n_kv_heads=s["KV"],
        head_dim=s["D"], d_ff=s["ff"], vocab=s["V"],
        attention="swa" if s["window"] else "full",
        swa_window=s["window"] or 4096, rope_theta=s["theta"], norm_eps=s["eps"],
        tie_embeddings=s["tied"], moe=moe)


def engine_config(config: Dict) -> EngineConfig:
    return EngineConfig(**config["engine"])


def build(config: Dict, s: Dict, seed: int, device: str) -> InferenceEngine:
    """The engine of the cell's deployment, its model holding the
    benchmark's weights of ``seed``."""
    cfg = model_config(config, s)
    model = Transformer(cfg, device=device, dtype=DTYPES[config["torch_dtype"]],
                        seed=None)
    weights.fill(dict(model.named_parameters()), s, seed)
    return InferenceEngine(cfg, engine_config(config), TorchRunner(model, device=device),
                           virtual_clock=False)


def device_name(device: str) -> str:
    return torch.cuda.get_device_name() if device == "cuda" else device
