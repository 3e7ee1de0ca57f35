"""What the per-layer metrics' readers (`hgsbench/metrics/<name>.py`)
share. A reader takes the run (`run.out`: the driver's output, with the
trainer's `records` of the window or the viewer's `spans`, and the kept
compositor calls; `run.trace`: the parsed profiler trace) and returns a
number, or None where the run holds nothing for it to read."""
from __future__ import annotations

import statistics

from hgsbench import counts, trace

KERNEL_NAMES = {"k1": "raster3d_fwd_kernel", "k2": "raster3d_bwd_kernel",
                "k3": "raster2d_fwd_kernel", "k4": "raster2d_bwd_kernel"}
CALL_KIND = {"k1": "3d", "k2": "3d", "k3": "2d", "k4": "2d"}


def host_ms(records: dict) -> list:
    """Per iteration of the window, its host ms outside the step."""
    return [a - b for a, b in zip(records["iteration_ms"],
                                  records["step_ms"])]


def untraced(run) -> list:
    """Indices into the window's records outside the profiler's stretch
    (its rows and the one that writes the trace), whose host time the
    profiler inflates."""
    n = len(run.out["records"]["step_ms"])
    rows = run.out.get("traced_rows")
    if rows is None:
        return list(range(n))
    return [i for i in range(n) if not rows[0] <= i <= rows[1]]


def epoch_rows(run) -> list:
    """Indices into the window's records of each densify epoch's
    iteration."""
    first = run.out["window_first"]
    return [d["iteration"] - first for d in run.out["records"]["densify"]]


def kernel_pairs(run, kernel: str):
    """[(seconds, Pairs), ...] of the kept calls of `kernel`, matched in
    launch order with its kernels in the trace."""
    calls = [c for c in run.out.get("calls", [])
             if c["kind"] == CALL_KIND[kernel]]
    if run.trace is None or not calls:
        return []
    durs = trace.kernel_calls(run.trace, KERNEL_NAMES[kernel])
    return list(zip(durs[:len(calls)], [c["pairs"] for c in calls]))


def roofline(run, kernel: str):
    """The kept calls' least time over their measured time, in %."""
    got = kernel_pairs(run, kernel)
    if not got or run.sfu_rate is None:
        return None
    least = sum(counts.least_seconds(kernel, p, run.sfu_rate)
                for _, p in got)
    return counts.percent(least, sum(d for d, _ in got))


def idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def median(xs):
    return statistics.median(xs) if xs else None
