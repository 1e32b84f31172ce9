"""Mean rows of a decode call in the window (the benchmark's span around
``runner.decode``; the traced steps left out)."""


def read(obs):
    if not obs.decode:
        return None
    return sum(len(p) for _, _, p in obs.decode) / len(obs.decode)
