"""Mean host ms per iteration outside the step (the trainer's records:
iteration_ms - step_ms), leaving out each densify epoch's iteration and
the one after it (which rebuilds the step), and the profiler's stretch."""
from hgsbench.readers import epoch_rows, host_ms, untraced


def read(run):
    rec = run.out.get("records")
    if not rec or not rec["step_ms"]:
        return None
    skip = {j for e in epoch_rows(run) for j in (e, e + 1)}
    h = host_ms(rec)
    xs = [h[i] for i in untraced(run) if i not in skip]
    return sum(xs) / len(xs) if xs else None
