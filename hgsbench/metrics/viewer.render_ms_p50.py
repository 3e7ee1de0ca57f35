"""Median device ms (CUDA events) of a frame's render, the program's span
`viewer.render` around the render callback (`render_request`)."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "view", "viewer.render", "device_ms")
