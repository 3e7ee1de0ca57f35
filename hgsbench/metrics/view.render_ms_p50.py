"""Median ms of `render_request` per frame: the benchmark's span around
each call, synchronised before and after."""
from hgsbench.readers import median


def read(run):
    return median(run.out.get("spans", {}).get("render_ms", []))
