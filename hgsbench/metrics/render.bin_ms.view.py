"""Median device ms (CUDA events) of a frame's binning, the span
`render.bin` inside `viewer.render`."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "view", "render.bin", "device_ms",
                     parent="viewer.render")
