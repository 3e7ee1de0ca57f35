"""Median device ms (CUDA events) of a training view's binning, the span
`render.bin` inside `step.forward`: projection, cull, tile spans,
instance build and sort."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "render.bin", "device_ms",
                     parent="step.forward")
