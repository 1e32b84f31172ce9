"""Device time under the MoE layer's ``moe_dispatch`` and ``moe_combine``
ranges (``models/moe.py``) in the traced steps, per decode step."""


def read(obs):
    t = obs.trace
    if t is None or not obs.traced_decode or not obs.sizes["E"]:
        return None
    total = sum(t["in_ranges_s"].values())
    return total / len(obs.traced_decode) * 1e3 if total else None
