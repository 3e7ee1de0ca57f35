"""Mean ms a densify epoch adds: per epoch outside the profiler's
stretch, the host ms outside the step of the epoch's iteration
(roll-back, decision, host grow, repack) and of the next one (the step's
rebuild and the capacity's recalibration)."""
from hgsbench.readers import epoch_rows, host_ms, untraced


def read(run):
    rec = run.out.get("records")
    if not rec:
        return None
    h, ok = host_ms(rec), set(untraced(run))
    rows = [e for e in epoch_rows(run) if e in ok and e + 1 in ok]
    if not rows:
        return None
    return sum(h[e] + h[e + 1] for e in rows) / len(rows)
