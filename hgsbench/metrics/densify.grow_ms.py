"""Median host ms of a densify epoch's host growth and pruning
(`run_densify`'s "grow_ms", kept in the trainer's `records["densify"]`),
over the window's epochs outside the profiler's stretch, whose host time
the profiler inflates; None where the window held no such epoch."""
from hgsbench.readers import epoch_rows, median, untraced


def read(run):
    rec = run.out.get("records") if run.kind == "train" else None
    if not rec or not rec["densify"]:
        return None
    ok = set(untraced(run))
    return median([d["grow_ms"] for d, row in zip(rec["densify"],
                                                  epoch_rows(run))
                   if row in ok])
