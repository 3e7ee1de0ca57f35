"""Median device ms (CUDA events) of a training view's forward
composite, the span `render.composite` inside `step.forward`: K1 or K3
and the assembly of the image from its tile rows."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "render.composite", "device_ms",
                     parent="step.forward")
