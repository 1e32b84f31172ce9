"""The yardstick's arithmetic: the model's operations and the kernels'
operations and bytes, computed from shapes and lengths, and the peaks of
one NVIDIA H100 SXM they are read against.

Peaks: NVIDIA's data sheet, dense rates without sparsity, at the card's
full 700 W; every result line prints the card's ``power.limit`` beside
them. The kernels' symbols are the device function names of the port's
two hand-written kernels, as the profiler reports them."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_S = 3.35e12
DTYPE_BYTES = 2                     # bf16 weights, activations and cache

# every device kernel each hand-written kernel launches (K1: prefill's
# flash attention, K2: decode's paged attention); a bf16 run reaches the
# tensor-core instances, and the fp32 ones are listed so that none is missed
SYMBOLS: Dict[str, Tuple[str, ...]] = {
    "k1": ("flash_fwd_wgmma", "flash_fwd_simt"),
    "k2": ("paged_split_mma", "paged_split_simt", "paged_merge"),
}


def layer_matmul_params(s) -> int:
    """Weights one token multiplies by in one layer: the attention
    projections, and the dense MLP or the router and top_k experts."""
    d, H, KV, D, ff = s["d"], s["H"], s["KV"], s["D"], s["ff"]
    attn = d * H * D * 2 + d * KV * D * 2
    if s["E"]:
        return attn + d * s["E"] + s["top_k"] * 3 * d * ff
    return attn + 3 * d * ff


def head_params(s) -> int:
    return s["d"] * s["V"]


def attended(s, position: int) -> int:
    """Keys a query at ``position`` attends: itself and those before it,
    within the window."""
    n = position + 1
    return min(n, s["window"]) if s["window"] else n


def causal_pairs(s, n: int) -> int:
    """(query, key) pairs of a whole prompt of n tokens from position 0."""
    w = s["window"]
    if not w or n <= w:
        return n * (n + 1) // 2
    return w * (w + 1) // 2 + (n - w) * w


def attention_flops(s, pairs: int) -> int:
    """Scores and weighted values of ``pairs`` pairs, every layer and head."""
    return 4 * pairs * s["D"] * s["H"] * s["L"]


def decode_flops(s, positions: Iterable[int]) -> int:
    """A decode step's model operations: each row's token through every
    layer's weights and the head, and its attention over its keys."""
    positions = list(positions)
    per_row = 2 * (s["L"] * layer_matmul_params(s) + head_params(s))
    return len(positions) * per_row + attention_flops(
        s, sum(attended(s, p) for p in positions))


def prefill_flops(s, n: int) -> int:
    """A whole prompt of n tokens: every token through every layer, the
    head at the last position alone (the one token prefill returns)."""
    return (2 * n * s["L"] * layer_matmul_params(s) + 2 * head_params(s)
            + attention_flops(s, causal_pairs(s, n)))


def k1_bound_s(s, n: int) -> float:
    """K1's least time for a prompt of n tokens over every layer: the
    larger of its operations at the bf16 peak and its bytes (q, k and v
    read once, the output written once) at the HBM peak."""
    H, KV, D = s["H"], s["KV"], s["D"]
    ops = 4 * causal_pairs(s, n) * D * H
    byts = (2 * n * H * D + 2 * n * KV * D) * DTYPE_BYTES
    return s["L"] * max(ops / PEAK_FLOPS_BF16, byts / PEAK_BYTES_S)


def k2_bytes(s, positions: Iterable[int]) -> int:
    """K2's bytes for one decode step over every layer: each row's k and
    v of the keys it attends, in every kv head, and its q and output once."""
    KV, H, D = s["KV"], s["H"], s["D"]
    per_layer = sum(2 * attended(s, p) * KV * D + 2 * H * D for p in positions)
    return s["L"] * per_layer * DTYPE_BYTES
