"""K2's least time for the traced decode steps' rows (k and v of the keys
each row attends in every kv head, q and the output once, at the HBM
peak) over the device time of its kernels (``paged_split_mma``,
``paged_merge``), in percent."""


def read(obs):
    t = obs.trace
    if t is None or not obs.traced_decode:
        return None
    dev = sum(t["by_symbol_s"].get(k, 0.0) for k in obs.yard.SYMBOLS["k2"])
    if not dev:
        return None
    need = sum(obs.yard.k2_bytes(obs.sizes, p) for _, _, p in obs.traced_decode)
    return 100.0 * need / obs.yard.PEAK_BYTES_S / dev
