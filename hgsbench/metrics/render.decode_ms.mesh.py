"""Median device ms (CUDA events) of a training view's decode in a
sharded step: the span `render.decode` at the top of rank 0's record (the
mesh's step opens no `step.forward` around it), the LOD mask, the
prefilter and the MLP decode over the table."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "train", "render.decode", "device_ms",
                     parent=None)
