"""The decode calls' model operations (each row through every layer's
weights and the head, and its attention over the keys it attends) over
their wall time at the bf16 peak, in percent."""


def read(obs):
    if not obs.decode:
        return None
    flops = sum(obs.yard.decode_flops(obs.sizes, p) for _, _, p in obs.decode)
    wall = sum(b - a for a, b, _ in obs.decode)
    return 100.0 * flops / (wall * obs.yard.PEAK_FLOPS_BF16)
