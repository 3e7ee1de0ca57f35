"""Median device ms (CUDA events) of the training step's backward, the
span `step.backward`: autograd through the loss, K2 or K4 and the
decode."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "step.backward", "device_ms")
