"""Cells, configurations and traffic mixes, read from their files by name.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``bench/configs/<config>.json`` (the published sizes
under the source's own keys, the engine of the deployment and the
comparison's settings), its mix ``bench/traffic/<traffic>.json`` and its
own settings, where it has any (an open loop's rate, the comparison's
limit), ``bench/cells/<cell>.json``, laid over the mix's."""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = field(default=BENCH)

    @property
    def check(self) -> Dict[str, Any]:
        """The comparison's settings: the configuration's, then the cell's."""
        return {**self.config.get("check", {}), **self.traffic.get("check", {})}


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def metrics_of(entries: List[Dict[str, Any]], cell: str) -> List[Dict[str, Any]]:
    """The metrics of ``entries`` that ``cell`` reports: those whose
    ``workloads`` name it, and those without the key."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = BENCH.parent) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its
    configuration and mix read from their files under ``root``."""
    spec = _read(root / "BENCHMARK.json")
    bench_dir = root / "bench"
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    traffic = _read(bench_dir / "traffic" / f"{w['traffic']}.json")
    own = bench_dir / "cells" / f"{name}.json"
    if own.exists():
        traffic = {**traffic, **_read(own)}
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=metrics_of(spec["end_to_end"], name),
                per_layer=metrics_of(spec["per_layer"], name), bench_dir=bench_dir)


def model_sizes(config: Dict[str, Any]) -> Dict[str, Any]:
    """The decoder's sizes from a configuration file's published keys, as
    the benchmark's arithmetic and its reference read them."""
    c = config
    d = c["hidden_size"]
    H = c["num_attention_heads"]
    moe = c.get("num_local_experts", 0)
    return {
        "d": d, "L": c["num_hidden_layers"], "H": H,
        "KV": c["num_key_value_heads"], "D": c.get("head_dim") or d // H,
        "ff": c["intermediate_size"], "V": c["vocab_size"],
        "window": c.get("sliding_window") or 0,
        "theta": float(c["rope_theta"]), "eps": float(c["rms_norm_eps"]),
        "tied": bool(c.get("tie_word_embeddings", False)),
        "E": moe, "top_k": c.get("num_experts_per_tok", 0) if moe else 0,
    }
