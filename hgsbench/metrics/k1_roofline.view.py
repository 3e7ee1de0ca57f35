"""K1's share of its roofline serving a viewer frame (kept calls)."""
from hgsbench.readers import roofline


def read(run):
    return roofline(run, "k1") if run.kind == "view" else None
