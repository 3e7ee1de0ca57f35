"""Device ms a training step spends in the collectives' kernels (the
union of NCCL's kernels over the traced stretch, over its steps)."""
from hgsbench.readers import traced_steps


def read(run):
    steps = traced_steps(run)
    if not steps or not run.trace.collective_s:
        return None
    return 1e3 * run.trace.collective_s / steps
