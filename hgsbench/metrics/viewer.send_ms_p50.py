"""Median host ms of a frame's send, the span `viewer.send`: the frame's
bytes and the verify string onto the socket."""
from hgsbench.spans import median_ms


def read(run):
    return median_ms(run, "view", "viewer.send", "host_ms")
