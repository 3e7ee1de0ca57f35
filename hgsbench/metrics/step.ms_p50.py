"""Median host ms of the training step's call and the read of its loss
(the trainer's records["step_ms"]) over the window, outside the
profiler's stretch."""
from hgsbench.readers import median, untraced


def read(run):
    rec = run.out.get("records")
    if not rec:
        return None
    return median([rec["step_ms"][i] for i in untraced(run)])
