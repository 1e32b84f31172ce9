"""95th percentile of the time to first token, from the due time, over
every request due in the window (an open loop's)."""
from harness.stats import percentile, ttfts


def read(obs):
    if not obs.open_loop or not obs.due_in_window:
        return None
    return percentile(ttfts(obs.times, obs.due, obs.due_in_window, obs.t_start,
                            obs.t_close), 95) * 1e3
