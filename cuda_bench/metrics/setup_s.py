"""setup_s (s): process start to the window's first request: imports, the
kernel library's load, the weights made from the seed, and the warm-up."""


def read(run):
    return float(run["setup_s"])
