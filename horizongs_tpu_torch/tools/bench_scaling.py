"""The mesh's scaling: the sharded training step at 1..N ranks, the 1x1
band overhead, the per-band step-time skew, the N-card projection and the
load imbalance.

    python -m horizongs_tpu_torch.tools.bench_scaling [--devices 1,2,4,8]
    python -m horizongs_tpu_torch.tools.bench_scaling --tpu_overhead
    python -m horizongs_tpu_torch.tools.bench_scaling --band_times
    python -m horizongs_tpu_torch.tools.bench_scaling --project 8
    python -m horizongs_tpu_torch.tools.bench_scaling --imbalance

The JAX package's `tools/bench_scaling.py` on `torch.distributed`, its
command line and function names kept. Every mode trains or counts the
flagship LOD model of `__graft_entry__._flagship` (`_scene`: 20,000 points,
voxel 0.02, random decoders from a seeded generator) and runs on the card
unless `--device cpu` is given; without a card it raises. `--rasterizer`
takes the JAX names (tiled, pallas, auto, pallas_interpret): each selects
the port's one compositing path, K1/K2 (their plain versions on the CPU).

  * the sweep (no mode flag): each N of `--devices` is one
    `torch.distributed.run --nproc_per_node N` launch of this module's
    worker mode. The mesh is model = `--model_axis` when N divides by it,
    else 1; every data rank trains on the same view. Capacities are
    calibrated as the trainer calibrates them (`_calibrate`: each band's
    instances with its halo rows, the busiest (source, band) pair's
    records) at margin 1.5, doubled and re-run on a drop up to 16. A row
    holds the p50 step ms (the slowest rank's), rays/s, anchors,
    capacities, drops and each rank's K1/K2 launches and steps; for N > 1
    with a model axis, the pure data-parallel control on the same N ranks.
    When ranks share a card (gloo, `parallel/mesh.choose_backend`) or the
    host's CPU, `efficiency` is band over pure-DP total throughput within
    the run (`shared_card: true`); with a card per rank (NCCL) it is the
    speedup over linear.
  * `--tpu_overhead` (the JAX flag; the record is `card_1x1_overhead`):
    `ShardedTrainStep` on a one-rank 1x1 mesh against `TrainStep` at
    1920x1088 (`--width` x `--height` on the CPU), at least 10 steps a
    round, three interleaved rounds, the minimum round p50 of each.
  * `--band_times`: the full train step with zero learning rates on
    row-cropped cameras of `--views` street-like views at 1920x1088
    (`--width` x `--height` on the CPU), each band of n_model 2, 4 and 8
    with uniform and balanced bounds, min of 3 interleaved 4-step rounds;
    the fit t = c0 + c_row * rows + c_rec * records and the per-band times
    at the tallest band's static height. The analytic crop counts must
    agree with `count_render_instances` within 0.9-1.1 or the tool exits.
  * `--project N`: the efficiency of N cards from the measured
    `card_1x1_overhead` and `band_time_skew` and modelled collectives over
    NVLink 4 (`NVLINK_BW`); no kernel runs.
  * `--imbalance`: per-view instances and per-band record loads, uniform
    and balanced bounds; counts only, no kernel runs.

Every mode merges its record into `--out` (default `build/scaling.json`)
as the JAX tool merges its keys; each record carries the card's name and
power limit from `nvidia-smi`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from horizongs_tpu_torch.cli.train import JAX_RASTERIZERS
from horizongs_tpu_torch.tools.mesh_check import _kernels, _launches, _median

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "scaling.json"

# NVLink 4 of an H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): 900
# GB/s a card in total, 450 GB/s each way over its 18 links. The
# projection charges every collective phase at one card's one-way rate.
NVLINK_BW = 4.5e11                # B/s each way, a card
NVLINK_SOURCE = ("NVIDIA H100 SXM5 data sheet: NVLink 4, 900 GB/s a card "
                 "in total, 450 GB/s each way")
# a routed 3DGS record: the 10 fields and the binning radius, float32
# (`parallel/tile_exchange.py`)
RECORD_BYTES_3D = 11 * 4


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them (one
    line per distinct card), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi: {e})"
    return "; ".join(sorted({x.strip() for x in out.splitlines()
                             if x.strip()}))


def _scene(width: int, height: int, n_points: int, capacity: int,
           n_cams: int, model_axis: int, device, model=None):
    """(cfg, TrainState, cameras): the flagship LOD model on a synthetic
    cloud, its capacity the octree sample's anchors rounded up to
    4096-blocks (floored at `capacity`), then to the model axis; decoders
    from `torch.Generator().manual_seed(0)`, features and offsets zero.
    The same view (orbit camera 0) goes to each of `n_cams` data ranks: the
    work a view asks must not vary with the device count. `model` is a
    given (cfg, TrainState, cameras), for holding the tool to the JAX
    package's on the same model."""
    from horizongs_tpu_torch.data.synthetic import (
        orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.models.anchors import (
        init_anchor_state_from_points, octree_sample, round_capacity)
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.train.step import init_train_state
    if model is not None:
        cfg, ts, cams = model
        if (cams[0].width, cams[0].height) != (width, height):
            raise ValueError(f"the given cameras are {cams[0].width}x"
                             f"{cams[0].height}, not {width}x{height}")
        return cfg, ts, [cams[0]] * max(n_cams, 1)
    dev = torch.device(device)
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.02, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0)
    pts = random_gaussians(n_points, seed=0, extent=0.8,
                           scale_range=(0.01, 0.04))["means"]
    m = max(model_axis, 1)
    cap = max(round_capacity(len(octree_sample(pts, cfg)[0])), capacity or 0)
    cap = -(-cap // m) * m
    state = init_anchor_state_from_points(cfg, pts, capacity=cap, device=dev)
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim,
                     generator=torch.Generator().manual_seed(0), device=dev)
    cams = orbit_cameras(1, radius=3.5, height_z=-1.0, width=width,
                         height=height, device=dev)
    return cfg, init_train_state(state, mlps), cams * max(n_cams, 1)


def _calibrate(cfg, ts, cams, n_model: int, margin: float = 1.15):
    """(instance_cap, band_cap) of the band step, as `Trainer._calibrate_cap`
    and `_calibrate_band_cap` take them: each band's tile instances with
    its halo rows (`count_band_instances`) and, with more than one band,
    the records one (source rank, band) pair carries
    (`count_band_records`), their most over the views, times `margin`.
    The JAX tool takes n_instances // n_model a band, which overflows on
    views whose load is not even over the bands."""
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.parallel.step import (
        count_band_instances, count_band_records)
    from horizongs_tpu_torch.parallel.tile_exchange import suggest_band_cap
    args = (cfg, ts.params.mlps, ts.anchor_state(), n_model)
    n_inst = max(max(count_band_instances(c, *args, add_prefilter=False))
                 for c in cams)
    inst_cap = suggest_instance_cap(n_inst, margin=margin)
    band_cap = None
    if n_model > 1:
        n_rec = max(count_band_records(c, *args, add_prefilter=False)
                    for c in cams)
        band_cap = suggest_band_cap(n_rec, margin=margin)
    return inst_cap, band_cap


def _single_cap(cfg, ts, cams, margin: float = 1.15) -> int:
    """`TrainStep`'s instance capacity over the views, as the trainer's."""
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.render import count_render_instances
    n = max(count_render_instances(c, cfg, ts.params.mlps, ts.anchor_state(),
                                   add_prefilter=False) for c in cams)
    return suggest_instance_cap(n, margin=margin)


def build(mesh, scene, width: int, height: int, margin: float = 1.5):
    """The band step on `mesh` for `scene` = (cfg, TrainState, cameras):
    (step, sharded state, the batch's camera tensors, data, anchors,
    instance_cap, band_cap)."""
    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.parallel.step import (
        build_sharded_train_step, shard_state)
    from horizongs_tpu_torch.train.step import camera_tensors
    cfg, ts, cams = scene
    data, model = mesh.shape["data"], mesh.shape["model"]
    cams = [cams[0]] * data
    inst_cap, band_cap = _calibrate(cfg, ts, cams[:1], model, margin=margin)
    step = build_sharded_train_step(cfg, make_optim(start_stat=0), mesh,
                                    height, width, add_prefilter=False,
                                    shard_tiles=True, instance_cap=inst_cap,
                                    band_cap=band_cap)
    cts = [camera_tensors(c, do_stats=True) for c in cams]
    return (step, shard_state(ts, mesh), cts, data, int(ts.n), inst_cap,
            band_cap)


def time_step(step, ts, batch, warmup: int, iters: int):
    """(per-step ms, the most dropped, the final state, steps run): `warmup`
    steps (at least one), then `iters` steps each timed on the host clock
    up to the read of its loss. The state is updated in place, so a
    caller timing a variant again passes the returned state."""
    m = None
    n_warm = max(warmup, 1)
    for i in range(n_warm):
        ts, m = step(ts, batch, i + 1)
    dropped = int(m["n_dropped"])
    ms = []
    for i in range(iters):
        t0 = time.perf_counter()
        ts, m = step(ts, batch, i + 10)
        float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        dropped = max(dropped, int(m["n_dropped"]))
    return ms, dropped, ts, n_warm + iters


def _since(kernels, before) -> list:
    """Each kernel's launches since the counts `before`."""
    return [a - b for a, b in zip(_launches(kernels), before)]


def _run_config(mesh, scene, args, kernels) -> dict:
    """One mesh's band step on this rank, a drop re-run at a doubled
    margin up to 16 (every rank sees the mesh's most dropped, so all take
    the same turn); its kernels counted from its first step to its last."""
    before = _launches(kernels)
    margin, steps = 1.5, 0
    while True:
        step, ts, cts, data, n_anchors, inst_cap, band_cap = build(
            mesh, scene, args.width, args.height, margin=margin)
        ms, dropped, ts, n = time_step(step, ts, cts, args.warmup,
                                       args.iters)
        steps += n
        if not dropped or margin >= 16:
            break
        margin *= 2
        if mesh.is_main:
            print(f"mesh {data}x{mesh.shape['model']}: {dropped} dropped, "
                  f"widening the capacity margins to {margin} and "
                  f"re-running", flush=True)
    return {"mesh": [data, mesh.shape["model"]], "step_ms": ms,
            "step_ms_p50": _median(ms), "n_dropped": dropped,
            "margin": margin, "n_anchors": n_anchors,
            "instance_cap": inst_cap, "band_cap": band_cap,
            "steps_run": steps, "launches": _since(kernels, before)}


def _worker(args) -> int:
    """One rank of a sweep launch: the band step on this world's mesh and,
    with a model axis, the pure data-parallel control on the same ranks;
    the rank's record in <args.worker>/rank<r>.json."""
    import torch.distributed as dist

    from horizongs_tpu_torch.device import disable_tf32
    from horizongs_tpu_torch.parallel.mesh import (
        make_mesh, maybe_init_distributed)
    kernels, _ = _kernels("3D")
    rank = maybe_init_distributed(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = args.model_axis if world > 1 else 1
    model = model if world % model == 0 else 1
    disable_tf32()
    mesh = make_mesh(world // model, model, device=args.device)
    scene = _scene(args.width, args.height, args.n_points, args.capacity, 1,
                   model, mesh.device)
    rec = {"rank": rank, "world": world, "backend": mesh.backend,
           "band": _run_config(mesh, scene, args, kernels)}
    if world > 1 and model > 1:
        # pure-DP control on the same ranks (model=1, the same view, no
        # record exchange or model collectives): band over DP throughput
        # isolates the model axis's cost from how the ranks share the card
        rec["pure_dp"] = _run_config(make_mesh(world, 1, device=args.device),
                                     scene, args, kernels)
    out = Path(args.worker)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def _launch(n: int, args) -> list:
    """One `torch.distributed.run` launch of n worker ranks -> their
    records."""
    work = Path(tempfile.mkdtemp(prefix="hgs_scaling_"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), "-m",
           "horizongs_tpu_torch.tools.bench_scaling", "--worker", str(work),
           "--width", str(args.width), "--height", str(args.height),
           "--n_points", str(args.n_points), "--capacity",
           str(args.capacity), "--model_axis", str(args.model_axis),
           "--warmup", str(args.warmup), "--iters", str(args.iters)]
    if args.device:
        cmd += ["--device", args.device]
    path = os.pathsep.join(x for x in (str(ROOT), os.environ.get(
        "PYTHONPATH", "")) if x)
    env = dict(os.environ, PYTHONPATH=path,
               OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    try:
        p = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"the {n}-rank launch exited {p.returncode}:"
                               f"\n{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        ranks = []
        for r in range(n):
            with open(work / f"rank{r}.json") as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ranks


def _row_part(ranks, key) -> dict:
    """One configuration of a launch over its ranks: the slowest rank's
    p50 and every rank's figures."""
    cs = [r[key] for r in ranks]
    c0 = cs[0]
    return {"step_ms": max(c["step_ms_p50"] for c in cs),
            "step_ms_p50_per_rank": [c["step_ms_p50"] for c in cs],
            "mesh": f"{c0['mesh'][0]}x{c0['mesh'][1]}",
            "data": c0["mesh"][0], "n_anchors": c0["n_anchors"],
            "instance_cap": c0["instance_cap"], "band_cap": c0["band_cap"],
            "n_dropped": max(c["n_dropped"] for c in cs),
            "margin": c0["margin"],
            "launches_per_rank": [c["launches"] for c in cs],
            "steps_run_per_rank": [c["steps_run"] for c in cs]}


def run_scaling(args, dev) -> dict:
    counts = [int(x) for x in args.devices.split(",")]
    W, H = args.width, args.height
    results = []
    for n in counts:
        ranks = _launch(n, args)
        band = _row_part(ranks, "band")
        rays = W * H * band["data"] / (band["step_ms"] / 1e3)
        row = {"devices": n, "backend": ranks[0]["backend"], **band,
               "rays_per_sec": rays}
        print(f"devices={n:2d}  mesh {band['mesh']} ({row['backend']})  "
              f"step p50={band['step_ms']:8.2f} ms  rays/s={rays:,.0f}  "
              f"anchors={band['n_anchors']}  inst_cap="
              f"{band['instance_cap']}  band_cap={band['band_cap']}  "
              f"dropped={band['n_dropped']}", flush=True)
        if "pure_dp" in ranks[0]:
            dp = _row_part(ranks, "pure_dp")
            rays_dp = W * H * dp["data"] / (dp["step_ms"] / 1e3)
            row["pure_dp"] = dp
            row["rays_per_sec_pure_dp"] = rays_dp
            row["efficiency_vs_pure_dp"] = rays / rays_dp
            print(f"           pure-DP control {dp['mesh']}: step p50="
                  f"{dp['step_ms']:.2f} ms  rays/s={rays_dp:,.0f}  "
                  f"band/DP={rays / rays_dp:.3f}", flush=True)
        results.append(row)
    base = results[0]["rays_per_sec"]
    shared = any(r["backend"] == "gloo" and r["devices"] > 1
                 for r in results)
    for r in results:
        r["efficiency_linear"] = r["rays_per_sec"] / (base * r["devices"])
        r["efficiency_shared_card"] = r["rays_per_sec"] / base
        r["efficiency"] = (r.get("efficiency_vs_pure_dp", 1.0) if shared
                           else r["efficiency_linear"])
    return {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "card": card_name(dev), "shared_card": shared,
        "efficiency_definition": (
            "band-sharded vs pure-DP total throughput on the SAME N ranks "
            "(within-run control: the ranks share a card or the host's "
            "CPU, so the ideal is flat throughput; the flat-ideal number "
            "against the 1-rank run is kept as efficiency_shared_card)"
            if shared else "wall-clock speedup vs linear ideal"),
        "width": W, "height": H, "n_points": args.n_points,
        "capacity": args.capacity, "model_axis": args.model_axis,
        "rasterizer": "cuda", "warmup": args.warmup, "iters": args.iters,
        "results": results}


def run_tpu_overhead(args, dev) -> dict:
    """The card's bound on the band path's cost before any byte moves:
    `ShardedTrainStep` on a one-rank 1x1 mesh (its collectives the
    identity) against `TrainStep`, on the same state and view, at
    1920x1088 on the card. At least 10 timed steps a round, three rounds
    interleaved (plain, band, plain, band, ...), and each variant's
    minimum round p50: drift between rounds falls on both variants."""
    import torch.distributed as dist

    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.convert import train_state_to_device
    from horizongs_tpu_torch.parallel.mesh import (
        make_mesh, maybe_init_distributed)
    from horizongs_tpu_torch.parallel.step import (
        build_sharded_train_step, shard_state)
    from horizongs_tpu_torch.train.step import build_train_step, camera_tensors
    if args.iters < 10:
        args.iters = 12
    kernels, _ = _kernels("3D")
    maybe_init_distributed(device=args.device)
    if dist.is_initialized() and dist.get_world_size() != 1:
        raise ValueError("the 1x1 comparison runs on one rank")
    mesh = make_mesh(1, 1, device=args.device)
    W, H = (1920, 1088) if dev.type == "cuda" else (args.width, args.height)
    cfg, ts0, cams = _scene(W, H, args.n_points, args.capacity, 1, 1, dev)
    opt = make_optim(start_stat=0)
    ct = camera_tensors(cams[0], do_stats=True)
    margin = 1.15
    while True:
        cap_plain = _single_cap(cfg, ts0, cams[:1], margin)
        cap_band, _ = _calibrate(cfg, ts0, cams[:1], 1, margin)
        steps = {
            "plain": [build_train_step(cfg, opt, H, W, add_prefilter=False,
                                       instance_cap=cap_plain),
                      train_state_to_device(ts0, dev), ct],
            "band": [build_sharded_train_step(
                cfg, opt, mesh, H, W, add_prefilter=False, shard_tiles=True,
                instance_cap=cap_band), shard_state(ts0, mesh), [ct]]}
        rounds = {k: [] for k in steps}
        launches = {k: [0, 0] for k in steps}
        steps_run = {k: 0 for k in steps}
        dropped = {k: 0 for k in steps}
        for r in range(3):
            for name, ent in steps.items():
                before = _launches(kernels)
                ms, d, ent[1], n = time_step(
                    ent[0], ent[1], ent[2], args.warmup if r == 0 else 0,
                    args.iters)
                launches[name] = [a + b for a, b in zip(
                    launches[name], _since(kernels, before))]
                steps_run[name] += n
                dropped[name] = max(dropped[name], d)
                rounds[name].append(_median(ms))
            print(f"  round {r}: plain={rounds['plain'][-1]:.2f} ms  "
                  f"band={rounds['band'][-1]:.2f} ms", flush=True)
        if not any(dropped.values()) or margin >= 16:
            break
        margin *= 2
        print(f"dropped {dropped}: widening the capacity margin to {margin} "
              f"and re-running", flush=True)
    t_plain, t_band = min(rounds["plain"]), min(rounds["band"])
    ratio = t_band / t_plain
    print(f"card 1x1 overhead: plain={t_plain:.2f} ms  band={t_band:.2f} ms"
          f"  ratio={ratio:.3f}  anchors={ts0.n}", flush=True)
    return {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "card": card_name(dev), "backend": mesh.backend,
        "width": W, "height": H, "n_anchors": int(ts0.n),
        "rasterizer": "cuda", "iters": args.iters,
        "instance_cap": {"plain": cap_plain, "band": cap_band},
        "margin": margin, "plain_step_ms": t_plain, "band_step_ms": t_band,
        "band_overhead_ratio": ratio, "rounds_ms": rounds,
        "steps_run": steps_run, "launches": launches, "n_dropped": dropped,
        "note": ("band-sharded step on a one-rank 1x1 mesh vs the plain "
                 "step on the card: bounds the band path's cost before any "
                 "byte moves (records, band rows, the reduced loss); the "
                 "collectives are the identity at 1x1. Step ms are each "
                 "round's p50 (the loss read each step), min over 3 "
                 "interleaved rounds")}


def _zero_lr_optim():
    """The optimiser settings with every learning rate zero: the timed step
    runs the whole forward, backward and Adam, but leaves the parameters
    as they are, so a long timing campaign cannot drift the model (with
    real rates the zero target would fade the opacities, and later
    timings would measure a lighter scene)."""
    from horizongs_tpu_torch.config import DEFAULT_OPTIM, make_optim
    zeros = {k: 0.0 for k in DEFAULT_OPTIM
             if k.endswith(("_lr", "_lr_init", "_lr_final"))}
    return make_optim(start_stat=0, **zeros)


@torch.no_grad()
def flagship_view_spans(cfg, mlps, astate, cams, W, H, TILE_W, TILE_H):
    """Each view's per-gaussian tile spans: (y0, y1 unclipped tile rows,
    wspan clipped tile columns), numpy. A crop's instance count is then
    host arithmetic (`crop_counts`). The gates are the compositing
    wrapper's: projection valid and the alpha cut-off."""
    from horizongs_tpu_torch.models.anchors import (
        anchor_lod_mask, decode_neural_gaussians)
    from horizongs_tpu_torch.ops.binning import ellipse_extents
    from horizongs_tpu_torch.ops.raster_fields import pack_fields_3dgs
    n_tiles_x = -(-W // TILE_W)
    out = []
    for c in cams:
        mask, smooth = anchor_lod_mask(cfg, astate, c.cam_center, 1.0)
        dec = decode_neural_gaussians(cfg, mlps, astate, c.cam_center, mask,
                                      smooth, appearance_id=0)
        fields, radii, _ = pack_fields_3dgs(
            dec.means, dec.quats, dec.scales, dec.opacities, dec.colors,
            c.viewmat, c.K, W, H)
        rx, ry, _ = ellipse_extents(fields[:, 2:5], fields[:, 5])
        valid = (radii > 0) & (fields[:, 5] >= 1.0 / 255.0)
        mx, my = fields[:, 0], fields[:, 1]
        x0 = torch.clamp(torch.floor((mx - rx) / TILE_W), 0, n_tiles_x - 1)
        x1 = torch.clamp(torch.floor((mx + rx) / TILE_W), 0, n_tiles_x - 1)
        wspan = torch.where(valid, x1 - x0 + 1,
                            torch.zeros_like(x0)).int()
        y0 = torch.floor((my - ry) / TILE_H).int()      # unclipped
        y1 = torch.floor((my + ry) / TILE_H).int()
        out.append(tuple(x.cpu().numpy() for x in (y0, y1, wspan)))
    return out


def crop_counts(spans, row_a, row_b):
    """Instance count of the [row_a, row_b) tile-row crop: each splat whose
    vertical extent meets the crop adds its clipped rows x wspan. That is
    what the row-cropped camera enumerates (the projection culls splats
    whose box misses the crop) and what the band exchange routes to the
    band (the same box rule, `tile_exchange.band_span`)."""
    y0, y1, wspan = spans
    ov = np.clip(np.minimum(y1, row_b - 1) - np.maximum(y0, row_a) + 1,
                 0, row_b - row_a)
    return int(np.sum(wspan * np.maximum(ov, 0)))


def _crop_camera(cam, y0: int, h: int):
    """Rows [y0, y0 + h) of the view: the principal point moved up by the
    band's first row, so every splat projects as in the view and only the
    band's rows are binned and composited (what a band's rank composites,
    the exchange apart)."""
    K = cam.K.clone()
    K[1, 2] -= float(y0)
    return cam._replace(K=K, height=h, image=None, alpha_mask=None)


def run_band_times(args, dev, save_partial=None) -> dict:
    """Per-band step time on the card: for each band of an n_model-way row
    split, the plain train step (decode, bin, composite, loss, backward,
    zero-LR Adam) on the band's rows through a row-cropped camera, on
    street-like low views of the flagship scene; uniform and balanced
    bounds; min of 3 interleaved 4-step rounds.

    The skewed term (work proportional to records) is mirrored; two
    modelled deltas are stated: each crop decodes the whole table where a
    band's rank decodes 1/n_model of it (the same for every band), and the
    sharded step composites every band at the tallest band's height:
    `static_step_ms` adds c_row * (rows_max - rows_b) with the row cost
    fitted from these samples (t = c0 + c_row * rows + c_rec * records,
    least squares over every (view, crop) sample and the whole views).
    A crop whose step drops instances is re-timed at a doubled capacity
    margin, up to 16x."""
    from horizongs_tpu_torch.data.synthetic import orbit_cameras
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.ops.raster_fields import backend_tile_shape
    from horizongs_tpu_torch.parallel.step import count_view_row_loads
    from horizongs_tpu_torch.parallel.tile_exchange import (
        band_layout, suggest_band_bounds)
    from horizongs_tpu_torch.render import count_render_instances
    from horizongs_tpu_torch.train.step import build_train_step, camera_tensors
    kernels, _ = _kernels("3D")
    W, H = (1920, 1088) if dev.type == "cuda" else (args.width, args.height)
    TILE_W, TILE_H = backend_tile_shape("3D")
    cfg, ts, _ = _scene(W, H, args.n_points, args.capacity, 1, 1, dev)
    mlps, astate = ts.params.mlps, ts.anchor_state()
    opt0 = _zero_lr_optim()
    cams = orbit_cameras(args.views, radius=2.0, height_z=-0.15, width=W,
                         height=H, device=dev)
    n_tiles_y = -(-H // TILE_H)
    row_loads = sum(count_view_row_loads(c, cfg, mlps, astate,
                                         add_prefilter=False).cpu().numpy()
                    for c in cams)
    view_spans = flagship_view_spans(cfg, mlps, astate, cams, W, H, TILE_W,
                                     TILE_H)

    def crop_count(v, row_a, row_b):
        return crop_counts(view_spans[v], row_a, row_b)

    # the analytic whole-view count must agree with the production counter:
    # counting splats the projection culls would oversize every band's cap
    n_ref = count_render_instances(cams[0], cfg, mlps, astate,
                                   add_prefilter=False)
    n_ana = crop_count(0, 0, n_tiles_y)
    guard = {"analytic": n_ana, "production": n_ref,
             "ratio": n_ana / max(n_ref, 1)}
    if not 0.9 <= guard["ratio"] <= 1.1:
        raise SystemExit(f"analytic span count {n_ana} disagrees with "
                         f"count_render_instances {n_ref}")
    print(f"count guard: analytic {n_ana} vs production {n_ref} "
          f"({guard['ratio']:.3f})", flush=True)

    steps = {}                                 # (h, cap) -> step
    tally = {"steps": 0, "launches": [0, 0], "dropped": 0, "rerun": 0}

    def step_for(h, cap):
        if (h, cap) not in steps:
            steps[h, cap] = build_train_step(cfg, opt0, h, W,
                                             add_prefilter=False,
                                             instance_cap=cap)
        return steps[h, cap]

    def time_once(crops, cap, rounds, iters):
        best = [float("inf")] * len(crops)
        dropped = [0] * len(crops)
        cts = [camera_tensors(c, do_stats=True) for c, _ in crops]
        state = ts
        before = _launches(kernels)
        for _ in range(rounds):
            for j, (_, h) in enumerate(crops):
                fn = step_for(h, cap)
                state, m = fn(state, cts[j], 1)          # warm-up
                d = int(m["n_dropped"])
                t0 = time.perf_counter()
                for i in range(iters):
                    state, m = fn(state, cts[j], i + 2)
                float(m["loss"])
                best[j] = min(best[j], (time.perf_counter() - t0) / iters)
                dropped[j] = max(dropped[j], d, int(m["n_dropped"]))
                tally["steps"] += iters + 1
        tally["launches"] = [a + b for a, b in zip(tally["launches"],
                                                   _since(kernels, before))]
        return best, dropped

    def time_crops(crops, n_max, rounds=3, iters=4):
        """crops: (camera, height). Interleaved rounds, min per crop; the
        capacity is the crops' most instances x 1.3, doubled while a crop
        drops. -> (seconds per crop, capacity)."""
        margin = 1.3
        while True:
            cap = suggest_instance_cap(n_max, margin=margin)
            best, dropped = time_once(crops, cap, rounds, iters)
            if not any(dropped) or margin >= 16:
                tally["dropped"] = max(tally["dropped"], max(dropped))
                return best, cap
            margin *= 2
            tally["rerun"] += 1
            print(f"  {sum(1 for d in dropped if d)} crops dropped "
                  f"instances: re-timing at margin {margin}", flush=True)

    partial = {}

    def save():
        if save_partial:
            save_partial(dict(partial, partial=True))

    # whole-view baseline: the data axis's skew and the fit's anchors
    full_counts = [crop_count(v, 0, n_tiles_y) for v in range(len(cams))]
    t_full, cap_full = time_crops([(c, H) for c in cams], max(full_counts))
    tv = np.asarray(t_full) * 1e3
    print("per-view step ms:", tv.round(2).tolist(),
          f" worst/mean={tv.max() / tv.mean():.3f}", flush=True)
    partial["per_view_1080p"] = {
        "instances": full_counts, "step_ms": tv.round(3).tolist(),
        "instance_cap": cap_full,
        "time_worst_over_mean": float(tv.max() / tv.mean())}
    save()

    # the fit's samples: (tile rows, records, ms)
    samples = [(n_tiles_y, full_counts[v], t_full[v] * 1e3)
               for v in range(len(cams))]
    bands_out = {}
    partial["bands"] = bands_out
    for n_m in (2, 4, 8):
        per_variant = {}
        variants = {"balanced": suggest_band_bounds(row_loads, n_m),
                    "uniform": None}
        crops_all = {}
        for name, bounds in variants.items():
            layout = band_layout(H, W, n_m, TILE_H, bounds)
            crops = []
            for b in range(n_m):
                y0 = layout.starts_px[b]
                crops.append((y0, min(layout.heights_px[b], max(H - y0, 0))))
            crops_all[name] = (layout, crops)
        counts = {name: [[crop_count(v, y0 // TILE_H, (y0 + h) // TILE_H)
                          if h > 0 else 0 for (y0, h) in crops]
                         for v in range(len(cams))]
                  for name, (_, crops) in crops_all.items()}
        # one capacity for each n_m (the sharded step's one static cap),
        # from the busiest band of either variant
        n_max = max(max(max(row) for row in c) for c in counts.values())
        for name, (layout, crops) in crops_all.items():
            cnt = np.asarray(counts[name], np.float64)        # (V, n_m)
            todo = [(v, b) for b in range(n_m) for v in range(len(cams))
                    if crops[b][1] > 0]
            tt, cap = time_crops([(_crop_camera(cams[v], *crops[b]),
                                   crops[b][1]) for v, b in todo], n_max)
            t_ms = np.zeros((len(cams), n_m))
            for (v, b), t in zip(todo, tt):
                t_ms[v, b] = t * 1e3
                samples.append((crops[b][1] // TILE_H, cnt[v, b], t * 1e3))
            per_variant[name] = {
                "bounds": list(layout.bounds),
                "rows": [h // TILE_H for _, h in crops],
                "records": cnt.astype(int).tolist(),
                "step_ms": t_ms.round(3).tolist(),
                "instance_cap": cap}
            print(f"n_model={n_m} {name}: per-band ms "
                  f"{t_ms.mean(axis=0).round(2).tolist()}", flush=True)
            bands_out[str(n_m)] = {"instance_cap": cap, **per_variant}
            save()

    fit, bands_out = band_times_postprocess(samples, bands_out, tv,
                                            full_counts)
    return {
        "card": card_name(dev), "width": W, "height": H,
        "n_points": args.n_points, "capacity": args.capacity,
        "n_anchors": int(ts.n), "views": args.views, "rasterizer": "cuda",
        "count_guard": guard,
        "per_view_1080p": {
            "instances": full_counts, "step_ms": tv.round(3).tolist(),
            "instance_cap": cap_full,
            "time_worst_over_mean": float(tv.max() / tv.mean()),
            "load_fraction_f": fit["load_fraction_f"]},
        "fit": fit, "bands": bands_out,
        "steps_run": tally["steps"], "launches": tally["launches"],
        "n_dropped": tally["dropped"], "reruns": tally["rerun"],
        "note": ("the plain train step on row-cropped cameras (zero-LR "
                 "Adam; min of 3 interleaved 4-step rounds; instance caps "
                 "from each n_model's busiest band x 1.3, doubled while a "
                 "crop drops). static_step_ms adds back the tallest band's "
                 "static height (c_row fitted from these samples) that "
                 "the sharded step pays on every rank; crops decode the "
                 "whole table where a band's rank decodes 1/n_model "
                 "(the same for every band)")}


def band_times_postprocess(samples, bands_out, tv, full_counts):
    """Fit t = c0 + c_row * rows + c_rec * records over all (view, crop)
    samples, then add to `bands_out` the per-band times at the tallest
    band's static height and their worst over mean (mutates and
    returns it)."""
    A = np.asarray([[1.0, s[0], s[1]] for s in samples])
    y = np.asarray([s[2] for s in samples])
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    c0, c_row, c_rec = [float(x) for x in coef]
    resid = float(np.sqrt(np.mean((A @ coef - y) ** 2)))
    print(f"fit: t_ms = {c0:.2f} + {c_row:.3f}*tile_rows "
          f"+ {c_rec * 1e3:.4f}*krecords   rms={resid:.2f} ms", flush=True)

    for n_m_s, ent in bands_out.items():
        for name in ("uniform", "balanced"):
            if name not in ent:
                continue
            var = ent[name]
            rows = np.asarray(var["rows"])
            rows_max = rows.max()
            t = np.asarray(var["step_ms"])
            t_static = np.where(
                t > 0, t + c_row * (rows_max - rows)[None, :],
                c0 + c_row * rows_max)
            var["static_step_ms"] = t_static.round(3).tolist()
            wm = t_static.max(axis=1) / np.maximum(t_static.mean(axis=1),
                                                   1e-9)
            var["time_worst_over_mean_per_view"] = wm.round(3).tolist()
            var["time_worst_over_mean_max"] = float(wm.max())
            print(f"n_model={n_m_s} {name}: time worst/mean "
                  f"max={wm.max():.3f}", flush=True)

    # the load-proportional share of the whole step
    f_load = c_rec * float(np.mean(full_counts)) / float(tv.mean())
    fit = {"c0_ms": round(c0, 3),
           "c_row_ms_per_tile_row": round(c_row, 4),
           "c_rec_ms_per_record": c_rec,
           "rms_ms": round(resid, 3),
           "n_samples": len(samples),
           "load_fraction_f": round(f_load, 4)}
    return fit, bands_out


def _simulate_batches(costs: np.ndarray, n_d: int, policy: str,
                      epochs: int = 300, seed: int = 0):
    """The views of each step's batch over many epochs of a measured view
    pool. "random": the trainer's plain sampler (uniform without
    replacement). "dealt": its `balanced_batches` fill, a random leader
    and the views nearest its cost. Returns the batches' view indices (the
    pool is the measured views tiled to at least n_d)."""
    rng = np.random.default_rng(seed)
    n_views = len(costs)
    reps = max(-(-n_d // n_views), 1) * 2
    base = np.tile(np.arange(n_views), reps)
    batches = []
    for _ in range(epochs):
        pool = list(rng.permutation(base))
        while len(pool) >= n_d:
            lead = pool.pop(rng.integers(len(pool)))
            batch = [lead]
            if policy == "dealt":
                for _ in range(n_d - 1):
                    j = min(range(len(pool)),
                            key=lambda i: abs(costs[pool[i]] - costs[lead]))
                    batch.append(pool.pop(j))
            else:
                for _ in range(n_d - 1):
                    batch.append(pool.pop(rng.integers(len(pool))))
            batches.append(batch)
    return batches


def run_projection(args, prior: dict, dev) -> dict:
    """The efficiency of `--project` N cards from measured terms and
    modelled collectives: the per-(view, band) step times of
    `band_time_skew` (run `--band_times` first), the 1x1 band overhead
    ratio of `card_1x1_overhead` (`--tpu_overhead`), and the calibrated
    exchange volume over NVLink (`NVLINK_BW`). No kernel runs.

    Mesh n_d x n_m, n_d views a step; the step waits on its slowest rank:
      T_step = E_batches[max over the batch's views and bands of t(v, m)]
               * ovh + T1 * ovh * halo_frac + T_comm
      eff    = T1 / (n_m * T_step)
    with t(v, m) the measured band times at the tallest band's height and
    the batch expectation drawn under the trainer's sampling (random or
    cost-dealt batches; uniform or balanced bounds). T_comm, each at one
    card's one-way NVLink rate: the records' all_to_all, (n_m - 1) *
    band_cap * 44 B a rank, twice (the backward's transposed exchange);
    the table gradient's ring all-reduce over data, 2 (n_d - 1) / n_d of a
    rank's table bytes; the decoders' gradient sum over model,
    2 (n_m - 1) / n_m of their bytes. halo_frac charges the 2 x HALO extra
    rows of each band at the whole step's cost."""
    from horizongs_tpu_torch.parallel.step import HALO, count_band_records
    from horizongs_tpu_torch.parallel.tile_exchange import suggest_band_cap
    from horizongs_tpu_torch.train.optim import MLP_GROUPS

    ovh_rec = prior.get("card_1x1_overhead")
    if not ovh_rec:
        raise SystemExit("--project needs card_1x1_overhead in --out's file "
                         "(run --tpu_overhead on the card first)")
    bt = prior.get("band_time_skew")
    if not bt:
        raise SystemExit("--project needs band_time_skew in --out's file "
                         "(run --band_times on the card first: the "
                         "projection folds in the measured per-band step "
                         "times)")
    ovh = ovh_rec["band_overhead_ratio"]
    W, H = bt["width"], bt["height"]

    t_view = np.asarray(bt["per_view_1080p"]["step_ms"], np.float64)
    view_cost = np.asarray(bt["per_view_1080p"]["instances"], np.float64)
    T1 = float(t_view.mean()) / 1e3        # street-view mean, one card

    cfg, ts, cams = _scene(W, H, args.n_points, args.capacity, 1, 1, dev)
    mlps, astate = ts.params.mlps, ts.anchor_state()

    # the gradients that cross ranks (Adam's moments never do)
    p = ts.params
    C = int(p.anchor.shape[0])
    table_bytes = sum(int(np.prod(a.shape[1:])) * 4 * C
                      for a in (p.anchor, p.offset, p.feat, p.scaling_log))
    groups = p.groups()
    mlp_bytes = sum(w.numel() * 4 for g in MLP_GROUPS for w in groups[g])

    def mc_compute_ms(n_d, n_m, policy, variant):
        """E[max over the ranks] of the measured times, ms, before the
        overhead ratio."""
        if n_m == 1:
            t_dev = t_view[:, None]                       # (V, 1)
        else:
            ent = bt["bands"][str(n_m)]
            var = ent.get(variant) or ent["balanced"]
            t_dev = np.asarray(var["static_step_ms"], np.float64)
        batches = _simulate_batches(view_cost, n_d, policy)
        worst = [max(t_dev[v].max() for v in b) for b in batches]
        return float(np.mean(worst))

    rows = []
    n_total = args.project
    n_m_opts = [m for m in (1, 2, 4, 8) if m <= n_total
                and n_total % m == 0]
    for n_m in n_m_opts:
        n_d = n_total // n_m
        if n_m > 1:
            n_rec = count_band_records(cams[0], cfg, mlps, astate, n_m,
                                       add_prefilter=False)
            cap = suggest_band_cap(n_rec, margin=1.5)
            a2a_bytes = (n_m - 1) * cap * RECORD_BYTES_3D
        else:
            cap, a2a_bytes = 0, 0
        t_a2a = a2a_bytes / NVLINK_BW
        t_table = ((2 * (n_d - 1) / max(n_d, 1)) * (table_bytes / n_m)
                   / NVLINK_BW)
        t_mlp = (2 * (n_m - 1) / max(n_m, 1)) * mlp_bytes / NVLINK_BW
        # the backward runs the transposed exchange: the all_to_all twice
        t_comm = 2 * t_a2a + t_table + t_mlp
        halo_frac = 2 * HALO * (n_m - 1) / (H * max(n_m, 1))
        t_halo = T1 * ovh * halo_frac

        def eff_of(policy, variant):
            t_c = mc_compute_ms(n_d, n_m, policy, variant) / 1e3
            t_step = t_c * ovh + t_halo + t_comm
            return T1 / (n_m * t_step), t_step

        # the trainer's defaults under a mesh: cost-dealt batches and
        # uniform bounds; balanced bounds and random batches beside them
        eff_mit, t_mit = eff_of("dealt", "uniform")
        eff_bal, _ = eff_of("dealt", "balanced")
        eff_unmit, t_unmit = eff_of("random", "uniform")
        t_perfect = T1 * ovh * (1.0 / n_m + halo_frac) + t_comm
        rows.append({
            "mesh": f"{n_d}x{n_m}", "band_cap": cap,
            "t_step_ms": t_mit * 1e3,
            "t_step_ms_unmitigated": t_unmit * 1e3,
            "t_comm_ms": t_comm * 1e3,
            "t_a2a_ms": t_a2a * 1e3, "t_table_allreduce_ms": t_table * 1e3,
            "t_mlp_psum_ms": t_mlp * 1e3,
            "projected_efficiency": eff_mit,
            "projected_efficiency_balanced_bands": eff_bal,
            "projected_efficiency_unmitigated": eff_unmit,
            "projected_efficiency_perfect_balance":
                T1 / (n_m * t_perfect)})
        print(f"mesh {n_d}x{n_m}: step={t_mit*1e3:7.2f} ms "
              f"(comm {t_comm*1e3:5.3f} ms) eff={eff_mit:.3f} "
              f"(balanced-bands {eff_bal:.3f}, random-batch "
              f"{eff_unmit:.3f}, perfect-balance "
              f"{T1 / (n_m * t_perfect):.3f})", flush=True)
    best = max(rows, key=lambda r: r["projected_efficiency"])
    recommended = [r["mesh"] for r in rows
                   if r["projected_efficiency"] >= 0.8]
    return {
        "n_cards": n_total, "card": card_name(dev),
        "basis": {"street_view_mean_step_ms_1card": T1 * 1e3,
                  "per_view_step_ms": t_view.round(2).tolist(),
                  "band_overhead_ratio_1x1": ovh,
                  "overhead_card": ovh_rec.get("card"),
                  "band_times_card": bt.get("card"),
                  "table_grad_bytes": table_bytes,
                  "mlp_grad_bytes": mlp_bytes,
                  "link_bw_bytes_per_s_one_way": NVLINK_BW,
                  "link_bw_source": NVLINK_SOURCE,
                  "record_bytes": RECORD_BYTES_3D,
                  "halo_px": HALO, "width": W, "height": H},
        "meshes": rows,
        "best_mesh": best["mesh"],
        "projected_efficiency": best["projected_efficiency"],
        "imbalance_model": (
            "compute term = Monte-Carlo E[max over ranks] of the measured "
            "per-(view, band) step times (band_time_skew.static_step_ms) "
            "under the trainer's batch policy: headline = cost-dealt "
            "batches + uniform bounds (the defaults under a mesh); "
            "balanced bands and random batches kept beside it; "
            "perfect_balance = the step divided evenly, for comparison"),
        "recommended_meshes": recommended,
        "mesh_guidance": (
            f"meshes at or above 0.80: {', '.join(recommended) or 'none'}; "
            "a model axis divides the records and rows a rank composites "
            "but not its fixed cost (c0 + c_row * rows of "
            "band_time_skew.fit), so a model-heavy mesh buys memory (a "
            "table or image over one card) more than speed"),
        "note": ("analytic: measured 1x1 overhead and per-band step times, "
                 "calibrated exchange volume against one card's one-way "
                 "NVLink rate; the compute terms are measured, the "
                 "collectives modelled")}


def run_imbalance(args, dev) -> dict:
    """Band and data-axis load imbalance on street-like low views of the
    flagship scene (splats gather near the horizon rows): each band's
    routed-record load (column sums of the (source, band) matrix), uniform
    and balanced bounds, and each view's instances. The synchronous step
    waits on the slowest band or view, so worst/mean bounds what the skew
    can cost. Counts only: no kernel runs."""
    from horizongs_tpu_torch.data.synthetic import orbit_cameras
    from horizongs_tpu_torch.parallel.step import (
        count_band_matrix, count_view_row_loads)
    from horizongs_tpu_torch.parallel.tile_exchange import suggest_band_bounds
    from horizongs_tpu_torch.render import count_render_instances
    W, H = args.width, args.height
    cfg, ts, _ = _scene(W, H, args.n_points, args.capacity, 1, 1, dev)
    mlps, astate = ts.params.mlps, ts.anchor_state()
    cams = orbit_cameras(args.views, radius=2.0, height_z=-0.15, width=W,
                         height=H, device=dev)

    per_view_instances = [count_render_instances(
        c, cfg, mlps, astate, add_prefilter=False) for c in cams]
    inst = np.asarray(per_view_instances, np.float64)
    view_stats = {
        "per_view_instances": per_view_instances,
        "worst_over_mean": float(inst.max() / max(inst.mean(), 1.0))}
    print(f"DP view imbalance: instances min={inst.min():.0f} "
          f"mean={inst.mean():.0f} max={inst.max():.0f} "
          f"worst/mean={view_stats['worst_over_mean']:.2f}", flush=True)

    row_loads = sum(count_view_row_loads(c, cfg, mlps, astate,
                                         add_prefilter=False).cpu().numpy()
                    for c in cams)
    band_stats = {}
    for n_m in (2, 4, 8):
        bounds = suggest_band_bounds(row_loads, n_m)

        def _worst(bnds):
            loads = np.asarray([count_band_matrix(
                c, cfg, mlps, astate, n_m, add_prefilter=False,
                band_bounds=bnds).sum(0).cpu().numpy() for c in cams],
                np.float64)                      # per-band total records
            return loads, (loads.max(axis=1)
                           / np.maximum(loads.mean(axis=1), 1.0))

        loads_u, worst_u = _worst(None)
        loads_b, worst_b = _worst(bounds)
        band_stats[str(n_m)] = {
            "per_view_band_loads": loads_u.astype(int).tolist(),
            "worst_over_mean_per_view": worst_u.round(3).tolist(),
            "worst_over_mean_max": float(worst_u.max()),
            "balanced_bounds": list(bounds),
            "balanced_worst_over_mean_per_view": worst_b.round(3).tolist(),
            "balanced_worst_over_mean_max": float(worst_b.max())}
        print(f"band imbalance n_model={n_m}: uniform worst/mean max "
              f"{worst_u.max():.2f} -> balanced {worst_b.max():.2f} "
              f"(bounds {bounds})", flush=True)
    return {"card": card_name(dev), "width": W, "height": H,
            "n_anchors": int(ts.n), "views": args.views,
            "dp_view_imbalance": view_stats,
            "band_imbalance": band_stats,
            "note": ("street-like low-elevation views; worst/mean bounds "
                     "the synchronous step's loss to load skew (the step "
                     "waits on the slowest band or view)")}


def _parser() -> argparse.ArgumentParser:
    """The JAX tool's command line, with `--device` and the worker mode."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="1,2,4,8",
                    help="rank counts of the sweep, one launch each")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--n_points", type=int, default=20000)
    ap.add_argument("--capacity", type=int, default=0,
                    help="anchor-capacity floor (0 = sized from the "
                    "octree-sampled anchor count)")
    ap.add_argument("--model_axis", type=int, default=2,
                    help="model-axis size when divisible (data = N/model)")
    ap.add_argument("--rasterizer", default="tiled",
                    choices=("cuda", *JAX_RASTERIZERS),
                    help="every choice selects the cuda path (K1/K2)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--tpu_overhead", action="store_true",
                    help="the card's 1x1 band-vs-plain overhead (record "
                    "card_1x1_overhead) instead of the sweep")
    ap.add_argument("--project", type=int, default=0, metavar="N",
                    help="the N-card efficiency projection from the "
                    "measured records instead of a sweep")
    ap.add_argument("--imbalance", action="store_true",
                    help="band and view load imbalance on street-like "
                    "views instead of a sweep")
    ap.add_argument("--band_times", action="store_true",
                    help="per-band step-time skew through row-cropped "
                    "cameras (feeds --project)")
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; the card when omitted")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.worker:
        return _worker(args)

    from horizongs_tpu_torch.device import disable_tf32
    from horizongs_tpu_torch.parallel.mesh import rank_device
    dev = rank_device(args.device)          # raises without a card
    disable_tf32()
    prior = {}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                prior = json.load(f)
        except (OSError, ValueError):
            prior = {}

    def write(obj):
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(obj, f, indent=1)

    if args.tpu_overhead:
        prior["card_1x1_overhead"] = run_tpu_overhead(args, dev)
        out = prior
    elif args.band_times:
        def save_partial(partial):
            prior["band_time_skew"] = partial
            write(prior)
        prior["band_time_skew"] = run_band_times(args, dev, save_partial)
        out = prior
    elif args.project:
        prior[f"projected_efficiency_{args.project}card"] = \
            run_projection(args, prior, dev)
        out = prior
    elif args.imbalance:
        prior["load_imbalance"] = run_imbalance(args, dev)
        out = prior
    else:
        out = run_scaling(args, dev)
        for key in list(prior):
            if (key.startswith("projected_efficiency_")
                    or key in ("card_1x1_overhead", "load_imbalance",
                               "band_time_skew")):
                out[key] = prior[key]
    write(out)
    if "results" in out and not (args.tpu_overhead or args.project
                                 or args.imbalance or args.band_times):
        r = out["results"][-1]
        print(f"wrote {os.path.relpath(args.out)}; efficiency "
              f"@{r['devices']} ranks: {r['efficiency']:.3f}"
              + (" (shared card: band vs pure-DP within the run)"
                 if out["shared_card"] else ""), flush=True)
    else:
        print(f"wrote {os.path.relpath(args.out)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
