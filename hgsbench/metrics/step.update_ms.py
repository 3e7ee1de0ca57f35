"""Median device ms (CUDA events) of the training step's update, the
span `step.update`: Adam, the densify statistics and the metrics."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "step.update", "device_ms")
