"""The SH colours' cost in a training step: their evaluation alone, and a
step's backward split by where each autograd node came from.

    python -m horizongs_tpu_torch.tools.profile_sh alone [--rows N]
    python -m horizongs_tpu_torch.tools.profile_sh split TRACE.json

`alone` times `ops/reference._sh_colors` at degrees 0, 1 and 2 over
`rows` rows of random coefficients (10,035,200 by default: a table of
1,003,520 anchors x 10 offsets), forward and backward, with CUDA events
(the median of 10 after 3 warm-up calls), the memory the backward's
graph holds above its inputs, and the profiler's kernels of three
degree-2 calls. It needs a card.

`split` reads a chrome trace of training steps taken while the port's
spans record (the trainer's `profile_steps` trace,
`<model_path>/profile/trace.json`) and gives, a step, the device ms of
the kernels, copies and fills each part of the step launched:
  * the forward's by the innermost span it ran in (`render.decode`,
    `render.sh`, `render.bin`, `render.composite`; `step.forward` for the
    loss);
  * the backward's by the forward span of the autograd node whose
    evaluation launched it: a backward node carries the sequence number
    of the forward op that made it, and autograd's record of evaluating
    it (`autograd::engine::evaluate_function: <node>`) holds the node's
    own kernels and the adds that accumulate its outputs into the next
    nodes' gradients; the profiler's forward-backward flow names the op
    that made the node. The leaves' `AccumulateGrad` nodes are
    `accumulate`, work in `step.backward` outside any node `engine`;
  * `step.update` whole, and what ran outside the step's three spans
    (the trainer's own work) by its innermost span.
It also gives the nodes of each backward part, largest first. The split
is by node, so it needs no span on autograd's thread. Device ms are the
sum of each operation's own interval: on one stream, the busy time.
"""
from __future__ import annotations

import argparse
import bisect
import json

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NODE = "autograd::engine::evaluate_function: "
PHASES = ("step.forward", "step.backward", "step.update")


def _innermost(containers, items):
    """For each (ts, key) of `items`, the innermost of `containers`
    ((start, end, value), nested or disjoint, as a thread's annotations
    and ops are) open at ts, or None. Returns {key: value}."""
    out, stack = {}, []
    cs = sorted(containers, key=lambda c: (c[0], -c[1]))
    it = sorted(items)
    i = 0
    for ts, key in it:
        while i < len(cs) and cs[i][0] <= ts:
            while stack and stack[-1][1] < cs[i][0]:
                stack.pop()
            stack.append(cs[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def _add(d: dict, key, ms: float) -> None:
    d[key] = d.get(key, 0.0) + ms


def backward_split(trace) -> dict:
    """The split of `trace` (a chrome trace's path or its loaded dict)
    described in the module's docstring: {"steps": the `step.backward`
    spans, "forward", "backward", "update", "other": {part: device ms a
    step}, "nodes":
    {part: [[node, device ms a step, nodes a step], ...]}}. On a trace
    without device operations every ms is 0 and the node counts still
    hold."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ann = [e for e in ev if e.get("cat") == "user_annotation"]
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    steps = sum(1 for a in ann if a["name"] == "step.backward")
    if not steps:
        raise ValueError("the trace holds no `step.backward` span")

    def span(e):
        return (e["ts"], e["ts"] + e.get("dur", 0))

    by_tid = {}
    for e in ops:
        by_tid.setdefault(e["tid"], []).append(e)
    ann_by_tid = {}
    for a in ann:
        ann_by_tid.setdefault(a["tid"], []).append(a)
    # each op: the innermost span and the phase of its own thread, and
    # the backward node whose evaluation holds it
    span_of, phase_of, node_of = {}, {}, {}
    for tid, tops in by_tid.items():
        items = [(e["ts"], id(e)) for e in tops]
        mine = ann_by_tid.get(tid, [])
        span_of.update(_innermost([(*span(a), a["name"]) for a in mine],
                                  items))
        phase_of.update(_innermost([(*span(a), a["name"]) for a in mine
                                    if a["name"] in PHASES], items))
        node_of.update(_innermost(
            [(*span(e), e) for e in tops if e["name"].startswith(NODE)],
            items))
    # the op that made a node (the start of its forward-backward flow;
    # other ops record the same sequence number) -> the span it ran in
    at = {(e["tid"], e["ts"]): e for e in ops}
    seq_span = {}
    for f in trace["traceEvents"]:
        if f.get("cat") == "fwdbwd" and f.get("ph") == "s":
            op = at.get((f["tid"], f["ts"]))
            if op is not None:
                seq = op.get("args", {}).get("Sequence number")
                seq_span[seq] = span_of[id(op)]
    # the backward's windows: autograd's own thread opens no span
    bwd = sorted(span(a) for a in ann if a["name"] == "step.backward")
    starts = [s for s, _ in bwd]

    def in_backward(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= bwd[i][1]

    def node_part(node):
        if node["name"].endswith("AccumulateGrad"):
            return "accumulate"
        return seq_span.get(node.get("args", {}).get("Sequence number"),
                            "unmatched")

    def part_of(op):
        node = node_of[id(op)]
        if node is not None:
            return "backward", node_part(node), node
        phase = phase_of[id(op)]
        if phase == "step.backward" or (phase is None
                                        and in_backward(op["ts"])):
            return "backward", "engine", None
        if phase == "step.forward":
            return "forward", span_of[id(op)], None
        if phase == "step.update":
            return "update", phase, None
        return "other", span_of[id(op)] or "none", None

    by_ext = {e["args"]["External id"]: e for e in ops
              if "External id" in e.get("args", {})}
    out = {"forward": {}, "backward": {}, "update": {}, "other": {}}
    nodes, counts = {}, {}
    for e in ops:                       # node counts, with or without a card
        if e["name"].startswith(NODE):
            key = (node_part(e), e["name"][len(NODE):])
            counts[key] = counts.get(key, 0) + 1
            nodes.setdefault(key, 0.0)
    for k in dev:
        op = by_ext.get(k.get("args", {}).get("External id"))
        if op is None:
            continue
        phase, part, node = part_of(op)
        ms = k.get("dur", 0) / 1e3 / steps
        _add(out[phase], part, ms)
        if node is not None:
            _add(nodes, (part, node["name"][len(NODE):]), ms)
    grouped = {}
    for (part, name), ms in nodes.items():
        grouped.setdefault(part, []).append(
            [name, ms, counts.get((part, name), 0) / steps])
    for rows in grouped.values():
        rows.sort(key=lambda r: (-r[1], -r[2], r[0]))
    return {"steps": steps, **out, "nodes": grouped}


def sh_alone(rows: int, degrees=(0, 1, 2), device="cuda") -> list:
    """`_sh_colors` at each degree over `rows` rows, on the card: a dict
    a degree with the forward's and the backward's median device ms, the
    backward's peak memory above the inputs (GiB) and the least time of
    the evaluation's bytes, 12 (d+1)^2 + 24 a row, at 3.35 TB/s."""
    from horizongs_tpu_torch.ops.reference import _sh_colors
    from horizongs_tpu_torch.tools.timing import require_cuda
    dev = require_cuda(device)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    colors = (0.3 * torch.randn(rows, 9, 3, device=dev, generator=g)
              ).requires_grad_()
    means = torch.randn(rows, 3, device=dev, generator=g).requires_grad_()
    cam = torch.tensor([0.5, -4.0, 3.0], device=dev)
    cot = torch.randn(rows, 3, device=dev, generator=g)

    def once(deg):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        rgb = _sh_colors(colors, deg, means, cam)
        e[1].record()
        torch.autograd.grad(rgb, (colors, means), cot, allow_unused=True)
        e[2].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])

    out = []
    for deg in degrees:
        for _ in range(3):
            once(deg)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        xs = [once(deg) for _ in range(10)]
        out.append({
            "degree": deg,
            "forward_ms": sorted(x[0] for x in xs)[5],
            "backward_ms": sorted(x[1] for x in xs)[5],
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "least_ms": rows * (12 * (deg + 1) ** 2 + 24) / 3.35e12 * 1e3})
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            once(degrees[-1])
    top = sorted(prof.key_averages(), key=lambda k: -k.device_time_total)
    out.append({"kernels": [[k.key, k.count / 3, k.device_time_total / 3e3]
                            for k in top[:14]]})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("alone")
    a.add_argument("--rows", type=int, default=10_035_200)
    s = sub.add_parser("split")
    s.add_argument("trace")
    args = ap.parse_args(argv)
    if args.cmd == "alone":
        for row in sh_alone(args.rows):
            print(json.dumps(row))
    else:
        r = backward_split(args.trace)
        print(json.dumps({k: r[k] for k in ("steps", "forward", "backward",
                                             "update", "other")}))
        for part, rows in sorted(r["nodes"].items(),
                                 key=lambda kv: -r["backward"].get(kv[0], 0)):
            print(json.dumps({"part": part, "nodes": [
                [n, round(ms, 4), c] for n, ms, c in rows[:12]]}))


if __name__ == "__main__":
    main()
