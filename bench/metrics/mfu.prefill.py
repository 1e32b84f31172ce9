"""The prefill calls' model operations (every token through every layer,
the head at the last position, the causal pairs within the window) over
their wall time at the bf16 peak, in percent."""


def read(obs):
    if not obs.prefill:
        return None
    flops = sum(obs.yard.prefill_flops(obs.sizes, n) for _, _, n in obs.prefill)
    wall = sum(b - a for a, b, _ in obs.prefill)
    return 100.0 * flops / (wall * obs.yard.PEAK_FLOPS_BF16)
