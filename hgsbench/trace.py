"""Reading a torch.profiler chrome trace: the device's busy time as the
union of its operations' intervals over every stream (so a kernel beside
another on a second stream counts once), the traced window, each
compositor kernel's calls in order, the device operations that took most
time, the longest idle gaps by what the host was doing, and the
collectives' kernels (NCCL's): the union of their intervals, and the part
of it that no other device operation overlaps.

The busy union replaces the sum of kernel durations that
horizongs_tpu_torch/tools/timing.py::device_profile (commit 9bef012)
takes, which counts overlapping kernels twice.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160          # a breakdown entry keeps this much of a name
HOST_CATS = ("cpu_op", "user_annotation")


class Trace(NamedTuple):
    busy_s: float
    window_s: float
    kernels: dict          # name -> [duration_s, ...] in launch order
    device_ops: list       # [[name, seconds], ...] most time first
    idle_gaps: list        # [[host activity, seconds], ...] longest first
    collective_s: float = 0.0          # union of the NCCL kernels
    collective_exposed_s: float = 0.0  # of it, what nothing else overlaps


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length two merged interval lists share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _top_level(spans):
    """Host spans not inside another, sorted by start."""
    out = []
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if out and e <= out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def read(path: str, top: int = 10) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(ev["ts"]), float(ev["dur"]), ev["name"], cat))
        elif cat in HOST_CATS:
            host.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                         ev["name"]))
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    busy = _merge([(ts, ts + d) for ts, d, _, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    starts = [ts for ts, _, _, _ in dev] + [s for s, _, _ in host]
    ends = [ts + d for ts, d, _, _ in dev] + [e for _, e, _ in host]
    window_us = max(ends) - min(starts)

    kernels, by_name = defaultdict(list), defaultdict(float)
    for ts, d, name, cat in sorted(dev):
        by_name[name if cat == "kernel" else cat] += d
        if cat == "kernel":
            kernels[name].append(d / 1e6)

    # idle time inside the window, split by the host's outermost spans
    # over it ("python" where none is open)
    tops = _top_level(host)
    t_starts = [s for s, _, _ in tops]
    gaps = defaultdict(float)
    prev_end = min(starts)
    for s, e in busy + [[max(ends), max(ends)]]:
        if s > prev_end:
            covered = 0.0
            i = max(bisect.bisect_right(t_starts, prev_end) - 1, 0)
            while i < len(tops) and tops[i][0] < s:
                lap = min(tops[i][1], s) - max(tops[i][0], prev_end)
                if lap > 0:
                    gaps[tops[i][2]] += lap
                    covered += lap
                i += 1
            if s - prev_end - covered > 0:
                gaps["python"] += s - prev_end - covered
        prev_end = max(prev_end, e)

    def ranked(d):
        return [[k[:NAME_CHARS], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    comm = _merge([(ts, ts + d) for ts, d, name, cat in dev
                   if cat == "kernel" and "nccl" in name.lower()])
    rest = _merge([(ts, ts + d) for ts, d, name, cat in dev
                   if not (cat == "kernel" and "nccl" in name.lower())])
    comm_us = sum(e - s for s, e in comm)
    return Trace(busy_s=busy_us / 1e6, window_s=window_us / 1e6,
                 kernels=dict(kernels), device_ops=ranked(by_name),
                 idle_gaps=ranked(gaps), collective_s=comm_us / 1e6,
                 collective_exposed_s=(comm_us - _overlap(comm, rest)) / 1e6)


def kernel_calls(trace: Trace, fragment: str) -> list:
    """Durations (s) of the kernels whose name holds `fragment`, in launch
    order."""
    out = []
    for name, durs in trace.kernels.items():
        if fragment in name:
            out.extend(durs)
    return out
