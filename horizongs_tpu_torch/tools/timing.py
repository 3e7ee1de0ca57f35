"""Timing on the card, for the measurement tools and `chip_smoke.py`:
device time from CUDA events and from the profiler, launches replayed
back to back from a CUDA graph, and the host's time per launch. Each
needs a card: there is no time to take on the CPU."""
from __future__ import annotations

import time

import torch


def require_cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"timing needs a CUDA device, not {dev}")
    return dev


def best_ms(fn, iters: int = 20, rounds: int = 3) -> float:
    """Best over `rounds` of the mean device time of `iters` back-to-back
    calls of `fn` (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def busy_union(intervals) -> float:
    """The length of the union of (start, end) intervals: time covered
    by at least one of them, so two operations that overlap (on two
    streams, or one inside another) count once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_profile(fn) -> dict:
    """One call of `fn` under torch.profiler (made again, at most twice,
    where the trace holds no kernel), with no warm-up call (the caller
    makes one where it needs it): the host's wall ms ("wall_ms"), the
    device-busy ms ("busy_ms": the union of the device operations'
    intervals over every stream, `busy_union`), and each kernel's device
    ms by name ("by_name", summed over its calls). A call whose kernels
    take a few microseconds costs the host about as much to launch, so
    CUDA events around back-to-back calls would time the host; the
    profiler reads each kernel's own start and end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the profiler now and then records none of a CUDA graph's kernels
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, spans = {}, []
        for e in prof.events():
            # the spans' mirrors on the device timeline are no work
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
                spans.append((e.time_range.start, e.time_range.end))
        if by_name:
            return {"wall_ms": wall_ms, "busy_ms": busy_union(spans) / 1e3,
                    "by_name": by_name}
    raise RuntimeError("the profiler recorded no kernel on the device")


def graphed(fn, calls: int):
    """A function that replays `calls` calls of `fn`, captured once in a
    CUDA graph after one warm-up call: the card then runs their kernels
    back to back, with no host time between them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host wall time per call of `fn` over `calls` calls, the queue
    drained before and after (us)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls
