"""Median device ms (CUDA events) of a training view's SH colour
evaluation, the span `render.sh` inside `render.bin`: the view
directions, the SH basis at the step's degree over every decoded row,
the shift and the clamp (forward only; its backward runs inside
`step.backward`). RGB colours open no such span, and read None."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "render.sh", "device_ms",
                     parent="render.bin")
