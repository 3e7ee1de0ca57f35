"""Median device ms (CUDA events) of a training view's projection, the
span `render.project` inside `render.bin`: for 3DGS the projection, the
cull and the packing of K1's field row (on the card P1's forward,
`csrc/project3d.cu`), for 2DGS the surfel projection. Its backward runs
inside `step.backward`. A program without the span reads None."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "render.project", "device_ms",
                     parent="render.bin")
