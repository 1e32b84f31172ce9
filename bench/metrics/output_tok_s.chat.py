"""``output_tok_s`` where it is read per layer: every token the engine
generated in the window over its seconds, in a cell whose runs spread too
widely between processes for it to hold a bound end to end."""
from harness.stats import tokens_in_window


def read(obs):
    return tokens_in_window(obs.times, obs.t_start, obs.t_close) / obs.window_s
