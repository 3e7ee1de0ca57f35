"""Of the collectives' device ms a training step, those that no other
device operation overlaps: the time the step waits on them."""
from hgsbench.readers import traced_steps


def read(run):
    steps = traced_steps(run)
    if not steps or not run.trace.collective_s:
        return None
    return 1e3 * run.trace.collective_exposed_s / steps
