"""Seconds from the process's start to the window's: imports, the kernel
libraries' load (their build on a checkout's first run), the weights, the
engine and the warm-up that the cell's traffic needs."""


def read(obs):
    return obs.setup_s
