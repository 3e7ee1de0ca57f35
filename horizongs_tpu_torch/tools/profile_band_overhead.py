"""The band step's cost against the plain step at a 1x1 mesh, itemised by
kernel.

    python -m torch.distributed.run --standalone --nproc_per_node 1 \\
        -m horizongs_tpu_torch.tools.profile_band_overhead

The JAX package's `tools/profile_band_overhead.py` on the port. Both steps
train the flagship model of `chip_smoke.py` (phase 6's 1920x1088 scene,
`tools/mesh_check._scene`) on view 0 from the same state: `TrainStep` at
the trainer's single-device capacity and `ShardedTrainStep` on a 1x1 mesh
at the trainer's band calibration (`mesh_check._calibrate`). Each takes
`--warmup` steps, then `--iters` steps timed on the host clock (each
ending in the read of its loss: the p50; and back to back with one
synchronisation: the chained mean), then `--steps` steps under
`torch.profiler`. The profile is summed per kernel name over the card's
activity (kernels, copies, fills) and divided by the steps; the table's
rows are each name's launches and ms a step in both steps and their
difference, sorted by the difference (printed under `short_name`'s
labels). The total a step is the card's busy time, the union of those
intervals, so the rows sum to the busy difference when nothing overlaps;
`rows_match_total` holds them within 5%. Both come from the same event
list, so the check finds overlap and cannot find an activity the
profiler missed. K1's and K2's launches are counted a step in the
profiled steps (`launches_per_step`), over all of each step's
`steps_run` steps (`launches`), before the first step (`launches_setup`:
the scene's target renders), and over the whole process from its start
(`launches_process`).

On the CPU (`--device cpu`, a rehearsal at a small `--size`) the rows are
the host operators' self time instead: no device figure is written.
Writes one JSON object to `--out` (default under `build/`).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
from pathlib import Path

import torch

from horizongs_tpu_torch.tools.mesh_check import _calibrate, _median, _scene

DEFAULT_OUT = (Path(__file__).resolve().parents[2] / "build"
               / "band_profile.json")
MATCH_RTOL = 0.05
_NAMESPACES = re.compile(
    r"^void |at::native::|\(anonymous namespace\)::|binary_internal::")
_ELEMENTWISE = re.compile(
    r"(\w*elementwise_kernel)<\d+, (?:\d+, )?"
    r"(?:gpu_kernel_impl(?:_nocast)?<)?(.*)")


def short_name(name: str, width: int = 90) -> str:
    """A kernel name without PyTorch's namespaces, an elementwise kernel
    as `<its launcher>: <its functor>`, cut to `width`."""
    s = _NAMESPACES.sub("", name)
    m = _ELEMENTWISE.match(s)
    if m:
        s = f"{m.group(1)}: {m.group(2)}"
    return s[:width]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(step, state, cam, dev, warmup, iters):
    """(state, p50 ms with the loss read each step, chained mean ms)."""
    it = 0
    for _ in range(warmup):
        it += 1
        state, m = step(state, cam, it)
    float(m["loss"])
    ms = []
    for _ in range(iters):
        it += 1
        t0 = time.perf_counter()
        state, m = step(state, cam, it)
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        it += 1
        state, m = step(state, cam, it)
    _sync(dev)
    return state, _median(ms), (time.perf_counter() - t0) * 1e3 / iters


def _union_ms(intervals):
    """Total length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _profiled(step, state, cam, dev, n_steps, kernels):
    """Per-name (launches, ms) summed over n_steps steps under the
    profiler, the total (the card's busy time, or on the CPU the
    operators' self time) and each kernel's launches, all a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = [k.launches for k in kernels]
    _sync(dev)
    with profile(activities=acts) as prof:
        for i in range(n_steps):
            state, m = step(state, cam, 1000 + i)
        _sync(dev)
    launches = [k.launches - b for k, b in zip(kernels, before)]
    rows = {}
    if dev.type == "cuda":
        spans = []
        for e in prof.events():
            # the spans' mirrors on the device timeline are no work
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                n, ms = rows.get(e.name, (0, 0.0))
                rows[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
                spans.append((e.time_range.start, e.time_range.end))
        total = _union_ms(spans)
    else:
        for a in prof.key_averages():
            rows[a.key] = (a.count, a.self_cpu_time_total / 1e3)
        total = sum(ms for _, ms in rows.values())
    per = {k: (n / n_steps, ms / n_steps) for k, (n, ms) in rows.items()}
    return state, per, total / n_steps, [n / n_steps for n in launches]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--size", default="1920x1088", metavar="WxH")
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--steps", type=int, default=6,
                        help="profiled steps of each")
    parser.add_argument("--top", type=int, default=10,
                        help="rows printed")
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=None,
                        help="cpu for a rehearsal; the card when omitted")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.convert import train_state_to_device
    from horizongs_tpu_torch.device import disable_tf32
    from horizongs_tpu_torch.ops import raster3d
    from horizongs_tpu_torch.parallel.mesh import (
        make_mesh, maybe_init_distributed)
    from horizongs_tpu_torch.parallel.step import (
        build_sharded_train_step, shard_state)
    from horizongs_tpu_torch.train.step import (
        build_train_step, init_train_state)
    kernels = (raster3d.KERNEL, raster3d.KERNEL_BWD)
    for k in kernels:
        k.launches = 0
    maybe_init_distributed(device=args.device)
    if dist.is_initialized() and dist.get_world_size() != 1:
        raise ValueError("the 1x1 comparison runs on one rank")
    mesh = make_mesh(1, 1, device=args.device)
    dev = mesh.device
    disable_tf32()
    W, H = (int(x) for x in args.size.split("x"))
    scene = _scene(dev, W, H, "3D", args.points)
    cfg, cam = scene["cfg"], scene["cts"][0]
    band_cap_inst, _ = _calibrate(scene, 1)
    opt = make_optim(start_stat=0)
    ts0 = init_train_state(scene["state"], scene["mlps"])
    # the scene's target renders (K1) before any step
    setup = dict(zip(("K1", "K2"), (k.launches for k in kernels)))
    steps = {
        "plain": (build_train_step(cfg, opt, H, W,
                                   instance_cap=scene["cap"]),
                  train_state_to_device(ts0, dev), cam),
        "band": (build_sharded_train_step(cfg, opt, mesh, H, W,
                                          instance_cap=band_cap_inst),
                 shard_state(ts0, mesh), [cam])}
    res = {}
    for name, (step, state, c) in steps.items():
        before = [k.launches for k in kernels]
        state, p50, chained = _timed(step, state, c, dev, args.warmup,
                                     args.iters)
        _, per, total, launches = _profiled(step, state, c, dev,
                                            args.steps, kernels)
        res[name] = {"step_ms_p50": p50, "chained_ms": chained,
                     "total_ms": total, "per": per,
                     "launches_per_step": dict(zip(("K1", "K2"), launches)),
                     "steps_run": args.warmup + 2 * args.iters + args.steps,
                     "launches": dict(zip(("K1", "K2"), (
                         k.launches - b for k, b in zip(kernels, before))))}
    p, b = res["plain"]["per"], res["band"]["per"]
    rows = [{"name": k, "label": short_name(k),
             "launches_plain": p.get(k, (0, 0.0))[0],
             "launches_band": b.get(k, (0, 0.0))[0],
             "ms_plain": p.get(k, (0, 0.0))[1],
             "ms_band": b.get(k, (0, 0.0))[1]} for k in set(p) | set(b)]
    for r in rows:
        r["delta_ms"] = r["ms_band"] - r["ms_plain"]
    rows.sort(key=lambda r: -abs(r["delta_ms"]))
    rows_sum = sum(r["delta_ms"] for r in rows)
    diff = res["band"]["total_ms"] - res["plain"]["total_ms"]
    on_card = dev.type == "cuda"
    out = {
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "source": ("the card's activity by kernel name (torch.profiler)"
                   if on_card else "host operators' self time (the CPU)"),
        "backend": mesh.backend, "size": [W, H],
        "anchors": int(scene["state"].n),
        "instance_cap": {"plain": scene["cap"], "band": band_cap_inst},
        "steps_profiled": args.steps, "iters_timed": args.iters,
        **{k: {x: v for x, v in r.items() if x != "per"}
           for k, r in res.items()},
        "launches_setup": setup,
        "launches_process": dict(zip(("K1", "K2"),
                                     (k.launches for k in kernels))),
        "total_diff_ms": diff, "rows_sum_ms": rows_sum,
        "rows_match_total": abs(rows_sum - diff)
        <= MATCH_RTOL * max(abs(diff), 1e-9),
        "rows": rows}
    what = "busy" if on_card else "host self"
    print(f"1x1 band step against TrainStep at {W}x{H} on {out['device']}: "
          f"p50 {res['band']['step_ms_p50']:.2f} / "
          f"{res['plain']['step_ms_p50']:.2f} ms, chained "
          f"{res['band']['chained_ms']:.2f} / "
          f"{res['plain']['chained_ms']:.2f} ms, {what} "
          f"{res['band']['total_ms']:.3f} / {res['plain']['total_ms']:.3f} ms "
          f"(+{diff:.3f}; rows sum {rows_sum:+.3f})", flush=True)
    print(f"{'delta ms':>9} {'band ms':>8} {'plain ms':>8} {'n band':>6} "
          f"{'n plain':>7}  name")
    for r in rows[:args.top]:
        print(f"{r['delta_ms']:+9.4f} {r['ms_band']:8.4f} "
              f"{r['ms_plain']:8.4f} {r['launches_band']:6.1f} "
              f"{r['launches_plain']:7.1f}  {r['label']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {os.path.relpath(args.out)}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
