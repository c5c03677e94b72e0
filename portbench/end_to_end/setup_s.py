"""Seconds from the process's start to the window's start: imports, the
kernels, the weights, the audio pool and the warm-up at the cell's shapes."""


def read(run):
    return run["setup_s"]
