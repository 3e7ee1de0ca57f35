"""The sharded training step on a mesh of ranks, against the single-device
step, and its timings.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m horizongs_tpu_torch.tools.mesh_check --case 2x2

Every rank builds the flagship LOD model of `chip_smoke.py` (random
weights from seed 0, 20,000 points, voxel 0.02) and its targets (the model
with feat from seed 1, rendered at orbit views); data index d trains on
view 2d. A band case's capacities are calibrated as the trainer calibrates
them (`_calibrate`): each band's instances with its halo rows over the
scene's views x 1.15, and the records of the busiest (source rank, band)
pair x 1.25 (`band_cap`). Each case is one step's reduced gradients
(`parallel/step.ShardedTrainStep`), gathered on rank 0 and held to the
single-device `TrainStep`'s on the same state (the weighted mean over the
batch's views): per tensor within 2e-4 x its max |grad|, each rank's loss
within rtol 1e-5 of its own view's, nothing dropped, and each kernel of
the case launched once on each rank. Then `--steps` timed steps (after 2
warm-up steps, the kernels' counts set to 0 just before and read after):
the host p50 of each rank, and in a second pass with the collectives
timed (`collectives.reset_stats(timing=True)`: a synchronisation before
and after each) their ms and the exchange's bytes; one step more under
`torch.profiler` on every rank (device-busy ms, NCCL's kernels apart, and
the host's costliest operations).

A case is `DxM[:2D][:replicated][:duplicate]`: the mesh, the surfel model
(the normal loss held, the timed steps with the distortion on too), the
all_gather fallback in place of bands, and one view repeated over "data"
at weight 1/D. `--case` may be given more times (1x2 when it is not
given); every case's mesh must take the whole world. Rank 0 prints one
JSON line. `--out DIR` writes each rank's record
(`rank<r>.json`); `--capture CASE` adds, for that case on each rank, the
kernels' arguments of one untimed step (`capture_<case>_rank<r>.pt`, the
forward and the backward kernel's, ':' written '_'), for holding them to
their plain versions.
The backend follows `parallel/mesh`: NCCL when each rank has a card of
its own, gloo when ranks share one. `--device cpu` runs on the CPU (gloo)
at a small size, for a rehearsal.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist

GRAD_TOL = 2e-4          # per tensor, times its max |grad|
LOSS_RTOL = 1e-5


def _scene(dev, W, H, gs_attr, n_points):
    """The flagship model, its two views (orbit angles 0 and pi) with their
    targets, and an instance capacity that covers either whole view."""
    from horizongs_tpu_torch.data.synthetic import (
        orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.models.anchors import (
        init_anchor_state_from_points)
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.render import count_render_instances, render
    from horizongs_tpu_torch.train.step import camera_tensors
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.02, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0, gs_attr=gs_attr)
    pts = random_gaussians(n_points, seed=0, extent=0.8,
                           scale_range=(0.01, 0.04))["means"]
    state = init_anchor_state_from_points(cfg, pts, device=dev)
    gen = torch.Generator().manual_seed(0)
    live = (torch.arange(state.capacity) < state.n)[:, None]
    feat = torch.randn(state.feat.shape, generator=gen) * live
    offset = torch.randn(state.offset.shape, generator=gen) * live[:, :, None]
    state = state._replace(feat=feat.to(dev), offset=offset.to(dev))
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim, generator=gen, device=dev)
    cams = orbit_cameras(4, radius=3.5, height_z=-1.0, width=W, height=H,
                         device=dev)[::2]
    feat1 = torch.randn(state.feat.shape,
                        generator=torch.Generator().manual_seed(1)) * live
    target = state._replace(feat=feat1.to(dev))
    cts, cap = [], 0
    with torch.no_grad():
        for c in cams:
            n = count_render_instances(c, cfg, mlps, state)
            cap = max(cap, suggest_instance_cap(n, margin=1.15))
            img = render(c, cfg, mlps, target, torch.zeros(3, device=dev),
                         instance_cap=suggest_instance_cap(
                             count_render_instances(c, cfg, mlps, target),
                             margin=1.15))["render"]
            cts.append(camera_tensors(c, image=img, do_stats=True))
    return {"cfg": cfg, "state": state, "mlps": mlps, "cams": cams,
            "cts": cts, "cap": cap}


def _calibrate(scene, n_model):
    """(instance_cap, band_cap) of a band step, as `Trainer._calibrate_cap`
    and `Trainer._calibrate_band_cap` take them at their first margins:
    each band's tile instances with its halo rows
    (`parallel.step.count_band_instances`) and, with more than one band,
    the records one (source rank, band) pair carries
    (`count_band_records`), their most over the scene's views."""
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.parallel.step import (
        count_band_instances, count_band_records)
    from horizongs_tpu_torch.parallel.tile_exchange import suggest_band_cap
    args = (scene["cfg"], scene["mlps"], scene["state"], n_model)
    n = max(max(count_band_instances(c, *args)) for c in scene["cams"])
    cap = suggest_instance_cap(n, margin=1.15)
    if n_model == 1:
        return cap, None
    n_rec = max(count_band_records(c, *args) for c in scene["cams"])
    return cap, suggest_band_cap(n_rec, margin=1.25)


def parse_case(spec: str) -> dict:
    """`DxM[:2D][:replicated][:duplicate]` -> the case's settings."""
    head, *flags = spec.split(":")
    unknown = set(flags) - {"2D", "replicated", "duplicate"}
    if unknown:
        raise ValueError(f"case {spec!r}: unknown flags {sorted(unknown)}")
    data, model = (int(x) for x in head.lower().split("x"))
    gs = "2D" if "2D" in flags else "3D"
    if gs == "2D" and "replicated" in flags:
        raise ValueError(f"case {spec!r}: the fallback is 3DGS-only")
    return {"name": spec, "data": data, "model": model, "gs": gs,
            "shard_tiles": "replicated" not in flags,
            "duplicate": "duplicate" in flags}


def _optims(gs):
    """(the gradient check's, the timed steps') optimiser settings: 2DGS
    holds the normal loss; the distortion, whose gradient is chaotic
    through near-edge-on surfels, runs in the timed steps only."""
    from horizongs_tpu_torch.config import make_optim
    if gs == "3D":
        opt = make_optim(start_stat=0)
        return opt, opt
    kw = dict(start_stat=0, lambda_normal=0.05, normal_start_iter=0)
    return make_optim(**kw), make_optim(**kw, lambda_dist=0.01,
                                        dist_start_iter=0)


def _kernels(gs):
    from horizongs_tpu_torch.ops import raster2d, raster3d
    if gs == "2D":
        return (raster2d.KERNEL_2D, raster2d.KERNEL_2D_BWD), (
            "rasterize2d_fwd", "rasterize2d_bwd")
    return (raster3d.KERNEL, raster3d.KERNEL_BWD), ("rasterize_fwd",
                                                    "rasterize_bwd")


def _launches(kernels):
    return [k.launches for k in kernels]


def _reset(kernels):
    for k in kernels:
        k.launches = 0


class _Capture:
    """Inside a with-block, record (on the card) the arguments of each call
    of `raster_cuda.<name>` for the names given."""

    def __init__(self, names):
        from horizongs_tpu_torch.ops import raster_cuda
        self.mod, self.names, self.calls = raster_cuda, names, {}

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.names}
        for n, fn in self.orig.items():
            def wrap(*args, _n=n, _fn=fn):
                self.calls.setdefault(_n, []).append(tuple(
                    a.detach().clone() if torch.is_tensor(a) else a
                    for a in args))
                return _fn(*args)
            setattr(self.mod, n, wrap)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mod, n, fn)


def _profile_step(fn, dev, top: int = 8) -> dict:
    """One call of `fn` under torch.profiler, on every rank (its collectives
    stay matched): host wall ms, the device's kernels summed (NCCL's
    apart: they wait for the peers on the card), the kernels with the
    most device time and the host operations with the most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    busy = nccl = 0.0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            if e.name.lower().startswith("nccl"):
                nccl += ms
            else:
                busy += ms
                by_name[e.name] = by_name.get(e.name, 0.0) + ms
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    kern = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall, "device_busy_ms": busy,
            "nccl_kernel_ms": nccl,
            "device_ms_top": [[k[:120], ms] for k, ms in kern[:top]],
            "host_self_ms_top": [[a.key, a.self_cpu_time_total / 1e3,
                                  a.count] for a in host[:top]]}


def _held_grads(got, want):
    """The worst per-tensor max |got - want| / max |want|."""
    worst = 0.0
    for k in want:
        for a, b in zip(got[k], want[k]):
            scale = float(b.abs().max())
            err = float((a.to(b.device) - b).abs().max())
            worst = max(worst, err / scale if scale > 0
                        else (0.0 if err == 0 else float("inf")))
    return worst


def run_case(case, scene, mesh, n_steps, capture_dir=None, ref_cache=None):
    """One case on this rank -> its record (rank 0's holds the check)."""
    from horizongs_tpu_torch.convert import train_state_to_device
    from horizongs_tpu_torch.parallel import collectives
    from horizongs_tpu_torch.parallel.step import (
        build_sharded_train_step, count_band_instances, count_band_matrix,
        shard_state)
    from horizongs_tpu_torch.train.densify import TABLES
    from horizongs_tpu_torch.train.step import (
        build_train_step, init_train_state)
    dev = mesh.device
    cfg, cts = scene["cfg"], scene["cts"]
    H, W = cts[0].image.shape[:2]
    n_data, n_model = case["data"], case["model"]
    if case["duplicate"]:
        views = [0] * n_data
        cams = [cts[0]._replace(loss_weight=1.0 / n_data)] * n_data
    else:
        if n_data > len(cts):
            raise ValueError(f"{case['name']}: {n_data} views, the scene "
                             f"has {len(cts)}")
        views = list(range(n_data))
        cams = [cts[v] for v in views]
    opt_grad, opt_timed = _optims(case["gs"])
    kernels, names = _kernels(case["gs"])
    ts0 = init_train_state(scene["state"], scene["mlps"])
    cap, band_cap = (_calibrate(scene, n_model) if case["shard_tiles"]
                     else (scene["cap"], None))
    kw = dict(instance_cap=cap, band_cap=band_cap,
              shard_tiles=case["shard_tiles"])
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    # the gradient check
    step = build_sharded_train_step(cfg, opt_grad, mesh, H, W, **kw)
    _reset(kernels)
    loss, _, side, grads, _ = step.value_and_grad(shard_state(ts0, mesh),
                                                  cams, 1.0)
    sync()
    rec = {"instance_cap": cap, "band_cap": band_cap,
           "launches_grad": _launches(kernels),
           "dropped": int(side["n_dropped_exchange"])
           + int(side["n_dropped_instances"]),
           "n_instances": int(side["n_instances"]),
           "records_local": int(side.get("records_local", 0)),
           "records_received": int(side.get("records_received", 0))}
    gm, world = mesh.group("model"), mesh.group("world")
    full = {k: [collectives.gather_rows(g, gm) if k in TABLES else g
                for g in v] for k, v in grads.items()}
    every = collectives.gather_rows(torch.tensor(
        [[float(loss), rec["dropped"], *rec["launches_grad"]]],
        dtype=torch.float64, device=dev), world).cpu()
    if mesh.is_main:
        single = build_train_step(cfg, opt_grad, H, W,
                                  instance_cap=scene["cap"])
        want, losses, wsum = None, [], sum(float(c.loss_weight)
                                           for c in cams)
        for v, c in zip(views, cams):
            key = (case["gs"], v)
            if ref_cache is None or key not in ref_cache:
                sl, _, pkg, g1, _ = single.value_and_grad(
                    train_state_to_device(ts0, dev), cts[v], 1.0)
                if int(pkg["n_dropped"]):
                    raise RuntimeError("the single-device reference dropped "
                                       "instances")
                ref = (float(sl), {k: [x.detach() for x in t]
                                   for k, t in g1.items()})
                if ref_cache is not None:
                    ref_cache[key] = ref
            else:
                ref = ref_cache[key]
            losses.append(ref[0])
            w = float(c.loss_weight) / wsum
            part = {k: [x * w for x in t] for k, t in ref[1].items()}
            want = part if want is None else {
                k: [a + b for a, b in zip(want[k], part[k])] for k in want}
        worst = _held_grads(full, want)
        rank_losses = every[:, 0].tolist()
        # rank d * n_model + m trains on view d
        loss_ok = all(abs(lo - losses[r // n_model])
                      <= LOSS_RTOL * abs(losses[r // n_model])
                      for r, lo in enumerate(rank_losses))
        # on the CPU the wrappers run the plain versions and count nothing
        per = [1, 1] if dev.type == "cuda" else [0, 0]
        launch_ok = all(row[2:].tolist() == per for row in every)
        rec.update(loss=rank_losses, loss_single_device=losses,
                   grad_worst_share_of_max=worst,
                   dropped_any=int(every[:, 1].max()),
                   held=bool(worst <= GRAD_TOL and loss_ok and launch_ok
                             and every[:, 1].max() == 0))
        if case["shard_tiles"] and n_model > 1:
            band = count_band_matrix(scene["cams"][views[0]], cfg,
                                     scene["mlps"], scene["state"], n_model)
            rec["band_matrix"] = band.cpu().tolist()
            rec["band_loads"] = band.sum(0).cpu().tolist()
    if case["shard_tiles"]:
        rec["band_instances_counted"] = count_band_instances(
            scene["cams"][views[mesh.d]], cfg, scene["mlps"],
            scene["state"], n_model)[mesh.m]
    del grads, full

    # the timed steps
    step = build_sharded_train_step(cfg, opt_timed, mesh, H, W, **kw)
    local = shard_state(ts0, mesh)
    it = 0
    for _ in range(2):
        it += 1
        local, m = step(local, cams, it)
    if capture_dir is not None:
        with _Capture(names) as cap:
            it += 1
            local, m = step(local, cams, it)
        sync()
        torch.save({"gs": case["gs"], "names": names,
                    "fwd": cap.calls[names[0]][0],
                    "bwd": cap.calls[names[1]][0]},
                   Path(capture_dir)
                   / f"capture_{case['name'].replace(':', '_')}_rank"
                     f"{mesh.rank}.pt")
    sync()
    _reset(kernels)
    ms, losses, dropped = [], [], []
    for _ in range(n_steps):
        it += 1
        t0 = time.perf_counter()
        local, m = step(local, cams, it)
        losses.append(float(m["loss"]))                  # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
        dropped.append(int(m["n_dropped"]))
    rec["launches_timed"] = _launches(kernels)
    collectives.reset_stats(timing=True)
    for _ in range(n_steps):
        it += 1
        local, m = step(local, cams, it)
    ops = json.loads(json.dumps(collectives.STATS["ops"]))
    collectives.reset_stats()
    box = [local]

    def one():
        box[0], _ = step(box[0], cams, it + 1)
    rec["profile"] = _profile_step(one, dev)
    a2a = ops.get("all_to_all", {"bytes": 0, "seconds": 0.0,
                                 "host_staged_calls": 0, "calls": 0})
    rec.update(steps=n_steps, step_ms=ms, step_ms_p50=_median(ms),
               losses=losses, dropped_timed=dropped,
               exchange={"calls_per_step": a2a["calls"] / n_steps,
                         "host_staged": a2a["host_staged_calls"] > 0,
                         "bytes_per_step": a2a["bytes"] / n_steps,
                         "ms_per_step": a2a["seconds"] * 1e3 / n_steps},
               collectives_ms_per_step=sum(o["seconds"] for o in ops.values())
               * 1e3 / n_steps, collectives=ops)
    if n_data * n_model == 1 and mesh.is_main:
        # the single-device step in the same process, for comparison
        single = build_train_step(cfg, opt_timed, H, W,
                                  instance_cap=scene["cap"])
        sts = train_state_to_device(ts0, dev)
        for i in range(2):
            sts, _ = single(sts, cams[0], i + 1)
        sms = []
        for i in range(n_steps):
            t0 = time.perf_counter()
            sts, sm = single(sts, cams[0], i + 3)
            float(sm["loss"])
            sms.append((time.perf_counter() - t0) * 1e3)
        sbox = [sts]

        def one_single():
            sbox[0], _ = single(sbox[0], cams[0], n_steps + 3)
        rec["single_device"] = {"step_ms_p50": _median(sms),
                                "profile": _profile_step(one_single, dev)}
    return rec


def _median(xs):
    xs = sorted(xs)
    return 0.5 * (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--case", action="append", default=None,
                        metavar="DxM[:2D][:replicated][:duplicate]",
                        help="repeatable; 1x2 when omitted")
    parser.add_argument("--size", default="1920x1088", metavar="WxH")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--threads", type=int, default=None,
                        help="torch.set_num_threads on each rank (the "
                        "launcher's OMP_NUM_THREADS when omitted)")
    parser.add_argument("--out", default=None, metavar="DIR")
    parser.add_argument("--capture", action="append", default=[],
                        metavar="CASE", help="write the kernels' arguments "
                        "of one step of this case into --out")
    parser.add_argument("--device", default=None,
                        help="cpu for a rehearsal; each rank's card when "
                        "omitted")
    args = parser.parse_args(argv)
    cases = [parse_case(c) for c in (args.case or ["1x2"])]

    from horizongs_tpu_torch.device import disable_tf32
    from horizongs_tpu_torch.parallel.mesh import (
        make_mesh, maybe_init_distributed)
    if args.threads:
        torch.set_num_threads(args.threads)
    rank = maybe_init_distributed(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    for c in cases:
        if c["data"] * c["model"] != world:
            raise ValueError(f"case {c['name']} needs {c['data'] * c['model']}"
                             f" ranks, the world has {world}")
    if args.capture and not args.out:
        raise ValueError("--capture writes into --out")
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    disable_tf32()
    W, H = (int(x) for x in args.size.split("x"))
    meshes, scenes, refs = {}, {}, {}
    report = {"world": world, "size": [W, H], "cases": {},
              "threads": torch.get_num_threads(),
              "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
              "cpu_count": os.cpu_count()}
    for c in cases:
        shape = (c["data"], c["model"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=args.device)
        mesh = meshes[shape]
        report["backend"] = mesh.backend
        if c["gs"] not in scenes:
            scenes[c["gs"]] = _scene(mesh.device, W, H, c["gs"], args.points)
        t0 = time.perf_counter()
        rec = run_case(c, scenes[c["gs"]], mesh, args.steps,
                       capture_dir=out if c["name"] in args.capture
                       else None, ref_cache=refs)
        rec["seconds"] = time.perf_counter() - t0
        report["cases"][c["name"]] = rec
    if out is not None:
        with open(out / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
    if rank == 0:
        print(json.dumps({**report, "cases": {
            k: {x: v[x] for x in ("held", "grad_worst_share_of_max",
                                  "loss", "instance_cap", "band_cap",
                                  "step_ms_p50", "exchange",
                                  "collectives_ms_per_step") if x in v}
            for k, v in report["cases"].items()}}), flush=True)
    held = all(v.get("held", True) for v in report["cases"].values())
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0 if held else 1


if __name__ == "__main__":
    raise SystemExit(main())
