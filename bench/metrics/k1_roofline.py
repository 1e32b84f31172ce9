"""K1's least time for the traced prefills (the larger of the causal pairs'
operations within the window at the bf16 peak and q, k, v and the output
at the HBM peak, every layer) over the device time of ``flash_fwd_wgmma``
and ``flash_fwd_simt``, in percent."""


def read(obs):
    t = obs.trace
    if t is None or not obs.traced_prefill:
        return None
    dev = sum(t["by_symbol_s"].get(k, 0.0) for k in obs.yard.SYMBOLS["k1"])
    if not dev:
        return None
    need = sum(obs.yard.k1_bound_s(obs.sizes, n) for _, _, n in obs.traced_prefill)
    return 100.0 * need / dev
