"""Median host ms of a frame's quantize, the span `viewer.quantize`: the
wait for the frame's last kernels, the copy to the host, and the clip,
scale and cast."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "view", "viewer.quantize", "host_ms")
