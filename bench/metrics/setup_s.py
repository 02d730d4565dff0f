"""Seconds from the process's start to the window's start: imports, weights
made on the device, the KV pool, the predictor's fit, the kernels' build or
load, and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
