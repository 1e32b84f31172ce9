"""Every token the engine generated in the window (decode tokens and the
first tokens of completed prefills), over the window's seconds."""
from harness.stats import tokens_in_window


def read(obs):
    return tokens_in_window(obs.times, obs.t_start, obs.t_close) / obs.window_s
