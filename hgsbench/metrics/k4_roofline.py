"""K4's share of its roofline in a training step (kept calls)."""
from hgsbench.readers import roofline


def read(run):
    return roofline(run, "k4")
