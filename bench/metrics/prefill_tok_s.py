"""Prompt tokens (a recompute's whole context included) over the wall
time inside ``runner.prefill`` in the window, the traced steps left out."""


def read(obs):
    if not obs.prefill:
        return None
    return sum(n for _, _, n in obs.prefill) / sum(b - a for a, b, _ in obs.prefill)
