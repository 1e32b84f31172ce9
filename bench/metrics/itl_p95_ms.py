"""95th percentile of every inter-token gap in the window, over all
requests; a prefill or recompute stall counts in it."""
from harness.stats import inter_token_gaps, percentile


def read(obs):
    gaps = inter_token_gaps(obs.times, obs.t_start, obs.t_close)
    return percentile(gaps, 95) * 1e3 if gaps else None
