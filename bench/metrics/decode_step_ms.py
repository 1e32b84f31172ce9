"""Mean wall time of ``runner.decode`` in the window (its span ends in the
tokens' copy to the host, a sync), the traced steps left out."""


def read(obs):
    if not obs.decode:
        return None
    return sum(b - a for a, b, _ in obs.decode) / len(obs.decode) * 1e3
