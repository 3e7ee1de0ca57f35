"""Median device ms (CUDA events) of a frame's composite, the span
`render.composite` inside `viewer.render`: K1 and the assembly of the
image."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "view", "render.composite", "device_ms",
                     parent="viewer.render")
