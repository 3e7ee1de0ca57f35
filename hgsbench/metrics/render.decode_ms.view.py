"""Median device ms (CUDA events) of a frame's decode, the span
`render.decode` inside `viewer.render`."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "view", "render.decode", "device_ms",
                     parent="viewer.render")
