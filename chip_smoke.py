#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`horizongs_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and `nvcc`. Phases, each of which fails the run (non-zero exit) on error:

  1. device  the card's name and power limit (nvidia-smi)
  2. build   K1 (`csrc/raster3d_fwd.cu`) with nvcc, timed
  3. kernel  K1 against its plain PyTorch version on a seeded 256x256
             scene with a saturated stack, duplicate means and empty tiles
  4. slice   the flagship LOD model (random weights from a seed) answers
             8 requests at 1920x1088 through `render(rasterizer="cuda")`;
             K1 must be launched once per request, outputs finite, nothing
             dropped; the device time of each layer and one profiled
             request; one 256x256 view against the dense oracle; K1 against
             its plain version on the inputs of a 1080p request, timed,
             beside its bound
  5. report  per-view timings, the layer breakdown, the kernels line, and
             last the device line

Prints nothing after a failure and exits non-zero without a card or
without the package beside it.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

# peak issue rates of one Hopper SM per clock (CUDA C programming guide,
# compute capability 9.0 throughput table): FP32 operations (an FMA
# counting two, 128 lanes) and special-function results (exp2, log2, rcp)
FP32_OPS_PER_SM_CLK = 256
SFU_OPS_PER_SM_CLK = 16
FP32_OPS_PER_PAIR = 15      # K1's arithmetic per pixel-gaussian pair
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def _device_profile(fn):
    """One call of `fn` under torch.profiler: wall ms, device-busy ms (sum
    of kernel durations) and the eight kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall_ms, sum(by_name.values()), top


def _compare_k1(kern, plain, atol):
    """Max errors of K1 against its plain version, and the tolerance check:
    acc rgb/alpha rows within `atol`, the depth row within `atol` + rtol
    2e-4 (values ~scene depth, f32 summation noise), exp(logT) atol 1e-4 (a
    pixel's final T is below 1e-4 either way once it stopped), i_fin
    within 1 chunk."""
    import torch
    (acc_k, lt_k), (acc_p, lt_p) = kern, plain
    rows = [0, 1, 2, 4]
    err_rows = (acc_k[:, rows] - acc_p[:, rows]).abs().max().item()
    d_err = (acc_k[:, 3] - acc_p[:, 3]).abs()
    err_depth = d_err.max().item()
    depth_ok = bool((d_err <= atol + 2e-4 * acc_p[:, 3].abs()).all())
    err_T = (torch.exp(lt_k[:, 0]) - torch.exp(lt_p[:, 0])).abs().max().item()
    fin_k, fin_p = lt_k[:, 1, 0], lt_p[:, 1, 0]
    fin_diff = (fin_k - fin_p).abs()
    ok = err_rows <= atol and depth_ok and err_T <= 1e-4 \
        and bool((fin_diff <= 1).all())
    return ok, {"acc_rgb_alpha": err_rows, "acc_depth": err_depth,
                "T": err_T, "i_fin_mismatched_tiles": int((fin_diff > 0).sum())}


def _live_pairs(fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y) -> int:
    """Pixel-gaussian pairs this data needs K1 to evaluate: for each pixel,
    the gaussians of its tile's segment up to the one after which its
    transmittance is at or below 1e-4 (the per-pixel stop)."""
    import torch
    from horizongs_tpu_torch.ops.raster3d import (
        LOG_T_EPS, local_pixel_coords, segment_alpha)
    lx, ly = local_pixel_coords(fields.device)
    starts = tile_starts.tolist()
    total = torch.zeros((), dtype=torch.int64, device=fields.device)
    for t in range(n_tiles_x * n_tiles_y):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        alpha = segment_alpha(fields[gauss_id[s:e].long()], t, n_tiles_x,
                              lx, ly)
        lam = torch.log1p(-alpha)
        excl = torch.cumsum(lam, dim=1) - lam
        total += (excl > LOG_T_EPS).sum()
    return int(total)


def _kernel_scene(dev):
    """~4k seeded gaussians for a 256x256 view: a random cloud, a
    stack of 800 in depth that saturates the central tiles, and 200 gaussians
    repeated five times at the same mean and depth (ties). The cloud
    leaves the image's border tiles empty."""
    import numpy as np
    import torch
    from horizongs_tpu_torch.data.synthetic import random_gaussians
    g = random_gaussians(2400, seed=3, extent=0.8, scale_range=(0.01, 0.06))
    rng = np.random.default_rng(7)
    n = 800
    stack = {
        "means": np.stack([rng.uniform(-0.7, 0.7, n),
                           rng.uniform(-0.7, 0.7, n),
                           np.linspace(-0.5, 0.5, n)], axis=1),
        "quats": np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
        "scales": np.full((n, 3), 0.12),
        "opacities": np.full((n,), 0.95),
        "colors": rng.uniform(0, 1, (n, 3)),
    }
    dup = {k: np.repeat(v[:200], 5, axis=0) for k, v in
           random_gaussians(200, seed=5, extent=0.6,
                            scale_range=(0.02, 0.05)).items()}
    dup["colors"] = rng.uniform(0, 1, (1000, 3))
    return {k: torch.from_numpy(np.concatenate(
        [g[k], stack[k], dup[k]]).astype(np.float32)).to(dev) for k in g}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "horizongs_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no horizongs_tpu_torch package in {root}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))

    from horizongs_tpu_torch import kernels
    from horizongs_tpu_torch.data.synthetic import (
        lookat_camera, orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.device import disable_tf32
    from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.ops import raster3d
    from horizongs_tpu_torch.ops.raster_cuda import (
        build_raster_inputs, suggest_instance_cap)
    from horizongs_tpu_torch.render import (
        count_render_instances, decode_view, render)

    # 1. device --------------------------------------------------------------
    card = _smi("name,power.limit")
    print(f"device: {card}", flush=True)
    sm_clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    disable_tf32()
    torch.set_grad_enabled(False)   # the serving path is forward only

    # 2. build ---------------------------------------------------------------
    built = kernels.build("raster3d_fwd")
    print(f"build raster3d_fwd: {built.seconds:.2f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain on a small scene -----------------------------------
    g = _kernel_scene(dev)
    cam = lookat_camera(width=256, height=256, eye=(0, 0, -4), device=dev)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             256, 256)
    counts = ri.inst.tile_starts.diff()
    _require(int(ri.inst.n_dropped) == 0, "instances dropped")
    k_args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
              ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    kern = raster3d.rasterize_fwd(*k_args)
    torch.cuda.synchronize()
    ok, errs = _compare_k1(kern, raster3d.rasterize_fwd_plain(*k_args),
                           atol=2e-5)
    n_sat = int((kern[1][:, 1, 0] * raster3d.G < counts.float()).sum())
    print(f"kernel vs plain 256x256: {int(ri.inst.n_instances)} instances, "
          f"{int((counts == 0).sum())} empty tiles, {n_sat} tiles stopped "
          f"early; errors {json.dumps(errs)}")
    _require(ok, "K1 disagrees with its plain version")

    # 4. the slice: flagship LOD model, 8 requests at 1920x1088 ---------------
    W, H, n_views = 1920, 1088, 8
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.02, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0)
    pts = random_gaussians(20000, seed=0, extent=0.8,
                           scale_range=(0.01, 0.04))["means"]
    state = init_anchor_state_from_points(cfg, pts, device=dev)
    # random weights in place of trained ones: feat ~ N(0, 1) and offsets
    # ~ N(0, 1) (in units of each anchor's offset scale) on live rows,
    # decoders at their Kaiming-uniform init, all from seed 0
    gen = torch.Generator().manual_seed(0)
    live = (torch.arange(state.capacity) < state.n)[:, None]
    feat = torch.randn(state.feat.shape, generator=gen) * live
    offset = torch.randn(state.offset.shape, generator=gen) * live[:, :, None]
    state = state._replace(feat=feat.to(dev), offset=offset.to(dev))
    mlps = init_mlps(cfg.feat_dim, cfg.view_dim, cfg.appearance_dim,
                     cfg.n_offsets, cfg.color_dim, generator=gen, device=dev)
    cams = orbit_cameras(n_views, radius=3.5, height_z=-1.0, width=W,
                         height=H, device=dev)
    bg = torch.zeros(3, device=dev)
    n_inst = [count_render_instances(c, cfg, mlps, state) for c in cams]
    cap = suggest_instance_cap(max(n_inst), margin=1.15)

    for c in cams:                                   # warm-up
        render(c, cfg, mlps, state, bg, instance_cap=cap)
    torch.cuda.synchronize()
    raster3d.KERNEL.launches = 0
    view_ms, pkgs = [], []
    for c in cams:
        t0 = time.perf_counter()
        pkg = render(c, cfg, mlps, state, bg, rasterizer="cuda",
                     instance_cap=cap)
        torch.cuda.synchronize()
        view_ms.append((time.perf_counter() - t0) * 1e3)
        pkgs.append(pkg)
    k1_launches = raster3d.KERNEL.launches
    _require(k1_launches == n_views,
             f"K1 launched {k1_launches} times for {n_views} requests")
    for pkg in pkgs:
        _require(pkg["render"].shape == (H, W, 3), "render shape")
        for key in ("render", "render_depth", "render_alphas"):
            _require(bool(torch.isfinite(pkg[key]).all()), f"{key} finite")
        _require(int(pkg["n_dropped"]) == 0, "instances dropped")
    alpha_mean = sum(float(p["render_alphas"].mean()) for p in pkgs) / n_views
    p50 = _median(view_ms)

    # where a request's time goes: device time of each layer (CUDA events
    # around decode, projection + binning, K1), and one profiled request
    stages = {"decode": [], "project_bin": [], "k1": []}
    for c in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        dec = decode_view(c, cfg, mlps, state)
        ev[1].record()
        ri = build_raster_inputs(dec.means, dec.quats, dec.scales,
                                 dec.opacities, dec.colors, c.viewmat, c.K,
                                 W, H, cap=cap)
        ev[2].record()
        raster3d.rasterize_fwd(ri.fields, ri.inst.gauss_id,
                               ri.inst.tile_starts, ri.grid.n_tiles_x,
                               ri.grid.n_tiles_y)
        ev[3].record()
        ev[3].synchronize()
        for i, k in enumerate(stages):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
    prof_wall, prof_busy, prof_top = _device_profile(
        lambda: render(cams[0], cfg, mlps, state, bg, instance_cap=cap))

    # one 256x256 view against the dense oracle
    small = orbit_cameras(1, radius=3.5, height_z=-1.0, width=256,
                          height=256, device=dev)[0]
    cap_s = suggest_instance_cap(
        count_render_instances(small, cfg, mlps, state), margin=1.15)
    out_c = render(small, cfg, mlps, state, bg, rasterizer="cuda",
                   instance_cap=cap_s)
    out_d = render(small, cfg, mlps, state, bg, rasterizer="dense")
    dense_err = {k: (out_c[k] - out_d[k]).abs().max().item()
                 for k in ("render", "render_alphas", "render_depth")}
    ed_ok = bool(((out_c["render_depth"] - out_d["render_depth"]).abs()
                  <= 2e-4 + 2e-4 * out_d["render_depth"].abs()).all())
    print(f"cuda vs dense 256x256: errors {json.dumps(dense_err)}")
    _require(dense_err["render"] <= 2e-4
             and dense_err["render_alphas"] <= 2e-4 and ed_ok,
             "cuda path disagrees with the dense oracle")

    # K1 at the main path's shapes: the inputs of the first request
    dec = decode_view(cams[0], cfg, mlps, state)
    ri = build_raster_inputs(dec.means, dec.quats, dec.scales, dec.opacities,
                             dec.colors, cams[0].viewmat, cams[0].K, W, H,
                             cap=cap)
    k_args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
              ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    kern = raster3d.rasterize_fwd(*k_args)
    plain = raster3d.rasterize_fwd_plain(*k_args)
    torch.cuda.synchronize()
    # the plain version's cumsum on the card sums log T in another order
    # than the kernel's walk, so over 2M pixels a gaussian at the T = 1e-4
    # stop may fall the other way: it is worth at most alpha * 1e-4
    ok, errs = _compare_k1(kern, plain, atol=1e-4)
    print(f"kernel vs plain 1920x1088: errors {json.dumps(errs)}")
    _require(ok, "K1 disagrees with its plain version at 1080p")
    k_ms = _time_ms(lambda: raster3d.rasterize_fwd(*k_args), 20)
    plain_ms = _time_ms(lambda: raster3d.rasterize_fwd_plain(*k_args), 1)
    pairs = _live_pairs(*k_args)
    instances = int(ri.inst.n_instances)
    n_pix = ri.grid.n_tiles * raster3d.P
    bytes_moved = (ri.fields.numel() * 4 + instances * 4
                   + ri.inst.tile_starts.numel() * 4 + n_pix * 7 * 4)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_sfu = pairs / (SFU_OPS_PER_SM_CLK * n_sm * sm_clock_hz)
    t_fp32 = pairs * FP32_OPS_PER_PAIR / (FP32_OPS_PER_SM_CLK * n_sm
                                          * sm_clock_hz)
    bound_s = max(t_bytes, t_sfu, t_fp32)

    # 5. report ----------------------------------------------------------------
    print(json.dumps({
        "slice": "render 1920x1088 flagship LOD (cuda)", "card": card,
        "views": n_views, "view_ms": view_ms, "view_ms_p50": p50,
        "views_per_s": 1e3 / p50,
        "anchors": state.n, "capacity": state.capacity,
        "decoded_gaussians": state.capacity * cfg.n_offsets,
        "instances_per_view": n_inst, "instance_cap": cap,
        "mean_alpha": alpha_mean}))
    print(json.dumps({
        "stages_ms_p50": {k: _median(v) for k, v in stages.items()},
        "profiled_request": {"wall_ms": prof_wall, "device_busy_ms": prof_busy,
                             "device_idle_share": 1 - prof_busy / prof_wall,
                             "top_kernels_ms": prof_top},
        "card": card}))
    print(json.dumps({"kernels": [{
        "name": "raster3d_fwd (K1)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/raster3d_fwd.cu",
        "replaces": "horizongs_tpu/ops/pallas/raster3d.py:189",
        "launches": k1_launches,
        "max_abs_err": max(errs["acc_rgb_alpha"], errs["acc_depth"],
                           errs["T"]),
        "errors": errs,
        "tolerance": "acc atol 1e-4 (depth + rtol 2e-4); exp(logT) atol "
                     "1e-4; i_fin within 1",
        "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if t_bytes >= max(t_sfu, t_fp32) else "operations",
        "library_ms": None,
        "pairs": pairs, "instances": instances,
        "sm_clock_mhz": sm_clock_hz / 1e6, "card": card}]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
