"""Median device ms (CUDA events) of the training step's forward, the
span `step.forward`: render and loss."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "step.forward", "device_ms")
