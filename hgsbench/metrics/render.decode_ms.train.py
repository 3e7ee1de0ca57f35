"""Median device ms (CUDA events) of a training view's decode, the span
`render.decode` inside `step.forward`: the LOD mask, the prefilter and
the MLP decode over the table."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "render.decode", "device_ms",
                     parent="step.forward")
