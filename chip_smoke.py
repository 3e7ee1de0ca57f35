#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`horizongs_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and `nvcc`. Phases, each of which fails the run (non-zero exit) on error:

  1. device    the card's name and power limit (nvidia-smi)
  2. build     K1 (`csrc/raster3d_fwd.cu`), K2 (`csrc/raster3d_bwd.cu`), K3
               (`csrc/raster2d_fwd.cu`), K4 (`csrc/raster2d_bwd.cu`) and the
               measurement tools' kernels T1
               (`csrc/raster3d_fwd_persistent.cu`), T2 (K2's source with
               -DK2_VARIANT=1..4) and T3 (`csrc/grid_overhead.cu`) with
               nvcc, one process each started together, timed, with
               ptxas's registers, shared memory and spills
  3. kernel    K1 and K2 against their plain PyTorch versions on a seeded
               256x256 scene with a saturated stack, duplicate means and
               empty tiles; K3 and K4 on the same scene as surfels plus
               surfels nearly edge-on to the view (|k_z| near 0, hits at
               z <= 0.01) and a faint patch (pixels that never cross
               T = 0.5); the backward kernels with seeded cotangents on
               every output, and gaussians no pixel walked must get exact
               zeros
  4. serve     the flagship LOD model (random weights from a seed) answers
               8 requests at 1920x1088 through `render(rasterizer="cuda")`;
               K1 must be launched once per request and K2-K4 never,
               outputs finite, nothing dropped; the device time of each
               layer and one profiled request; one 256x256 view against the
               dense oracle; K1 against its plain version on the inputs of
               a 1080p request, timed, beside its bound (the work its walk
               needs given its skip tests) and the bound with every walked
               pair computed in full, with its design's figures: ptxas's
               registers, shared bytes and spills, blocks per SM, and from
               the records and the plain copies of its skip tests the
               culled warp-gaussian steps, the rejected pairs and the lane
               efficiency (`_k12_counts`)
  5. serve 2D  the same model as surfels (`gs_attr="2D"`) answers 4 of
               those requests: K3 once per request and no other kernel,
               every output (render, depth, alphas, normals, normals from
               depth, distortion, median depth) finite, nothing dropped;
               the layers, one profiled request, a 256x256 view against the
               2DGS dense oracle, and K3 against its plain version on the
               first request's inputs, timed, beside its bound (the work
               its walk needs given its skip tests) and the bound with
               every walked pair intersected exactly, with its design's
               figures: ptxas's registers, shared bytes and spills, blocks
               per SM, and from the records and the plain copies of its
               skip tests the culled warp-surfel steps, the rejected pairs
               and the lane efficiency (`_k34_counts`)
  6. train     2 warm-up and 20 timed training steps at 1920x1088
               (`build_train_step(rasterizer="cuda")`) towards a render of
               the model with other features; K1 and K2 must be launched
               once per step and K3, K4 never, the loss finite and lower at
               the end, parameters and moments finite, statistics gathered,
               nothing dropped; the device time of forward, backward and
               update, and one profiled step; K2 against its plain version
               on the inputs and cotangents of the first timed step, timed,
               beside its bounds, with the same design figures
  7. train 2D  the same for the surfel model with the normal and
               distortion losses on from the first step: K3 and K4 once per
               step, K4 against its plain version at 1080p, with the
               same design figures
  8. tools     T1 (persistent K1, static and dynamic schedules) bit for bit
               against K1, two launches each, on the 256x256 scene and the
               inputs of 1080p request 0, then timed there and on the
               equal-L sweep (`tools/fused_fwd.py`); T2's five variants,
               each at K2's blocks per SM, timed on the JAX tool's scene
               and on the first training step's K2 inputs, "full" against
               K2 within K2_TOL (`tools/profile_bwd_variants.py`); T3's
               table of device us per block at 255-4080 blocks beside
               `zero_()`, launched back to back from a CUDA graph
               (`tools/profile_grid_overhead.py`). Serving and training
               (phases 4-7) must have launched none of them
  9. densify   one coarse `run_densify` epoch of the trained 3DGS state on
               the card (the statistics gates opened for 22 steps): at
               least one anchor grown and one pruned, equal to the same
               epoch on a CPU copy (n, levels, tables, moments,
               statistics), timed by phase; then 5 steps at the new
               capacity with a recalibrated cap: K1 and K2 once per step,
               K3, K4 and the tools never, nothing dropped, loss finite
 10. report    per-view and per-step timings, the layer breakdowns, the
               densify epoch, the tools' tables, the kernels line, and
               last the device line

Prints nothing after a failure and exits non-zero without a card or
without the package beside it.
"""
import collections
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# peak issue rates of one Hopper SM per clock (CUDA C programming guide,
# compute capability 9.0 throughput table): FP32 operations (an FMA
# counting two, 128 lanes) and special-function results (exp2, log2, rcp)
FP32_OPS_PER_SM_CLK = 256
SFU_OPS_PER_SM_CLK = 16
# K1 per walked pixel-gaussian pair, with every walked pair computed in
# full (the count before the skip tests, `bound_ms_all_exact`): one exp and
# ~15 FP32 operations; per pair that contributes, an exp (T) and a log1p
# and ~14 FP32 operations (csrc/raster3d_fwd.cu, "What bounds it")
FP32_OPS_PER_PAIR = 15
K1_SFU_CONTRIB, K1_FP32_CONTRIB = 2, 14
# K2 per walked pair: one exp (alpha) and ~16 FP32 operations; per pair
# that contributes (alpha >= 1/255) a log, an exp and a reciprocal more and
# ~40 FP32 operations more (csrc/raster3d_bwd.cu, "What bounds it")
K2_SFU_WALKED, K2_SFU_CONTRIB = 1, 3
K2_FP32_WALKED, K2_FP32_CONTRIB = 16, 40
# What K1's and K2's walks need, given their skip tests
# (csrc/raster3d_common.cuh): nothing for a pair in a warp-gaussian step the
# support box culls; for every other walked pair sigma and the rejection
# test (dx, dy, five rounded products, two sums, the compare and the stop
# check: ~12 FP32 operations); only for a pair the test does not reject
# the exp of alpha, its product, cap and cut (1 SFU, ~4 FP32); then the
# contributing work.
K12_FP32_TESTED = 12
K12_SFU_EXACT, K12_FP32_EXACT = 1, 4
K2_TOL = 2e-4               # per field, times that field's max |grad|
# K3 per walked pair: an exp (alpha), the reciprocal of each IEEE division
# (u, v; counted once) and ~50 FP32 operations; per pair that contributes a
# log1p and an exp (T) more and ~30 FP32 operations
# (csrc/raster2d_fwd.cu, "What bounds it")
K3_SFU_WALKED, K3_SFU_CONTRIB = 2, 2
K3_FP32_WALKED, K3_FP32_CONTRIB = 50, 30
# K4 per walked pair: K3's intersection; per pair that contributes a
# log1p, an exp, 1/(1 - alpha) and 1/kz more and ~140 FP32 operations
# (csrc/raster2d_bwd.cu)
K4_SFU_WALKED, K4_SFU_CONTRIB = 2, 4
K4_FP32_WALKED, K4_FP32_CONTRIB = 50, 140
# What K3's and K4's walks need, given their skip tests
# (csrc/raster2d_common.cuh): nothing for a pair in a warp-surfel step the
# support box culls; for every other walked pair the division-free part of
# the intersection (hu, hv, k, dx, dy, rho2d: 27 rounded operations) and
# the rejection test (5); only for a pair the test does not reject the
# rest of the exact intersection (the divisions, rho3d, z, the exp and the
# cut-offs: the two SFU results and the other ~23 of the 50 FP32
# operations above); then the contributing work. The *_WALKED constants
# charge the exact intersection to every walked pair, as for a walk
# without the skip tests (`bound_ms_all_exact`).
K34_FP32_TESTED = 27 + 5
K34_FP32_EXACT = K3_FP32_WALKED - 27
K34_SFU_EXACT = K3_SFU_WALKED
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# T2's variants (K2 with parts removed, csrc/raster3d_bwd.cu) keep K2's
# walk with its skip tests (`_k12_bound`); per contributing pair
# (SFU, FP32): no_color drops dL/dw's four products and the four colour /
# depth sums (~16 FP32), walk_only keeps only the log1p of the walk
T2_CONTRIB_OPS = {"full": (K2_SFU_CONTRIB, K2_FP32_CONTRIB),
                  "no_atomic": (K2_SFU_CONTRIB, K2_FP32_CONTRIB),
                  "no_color": (K2_SFU_CONTRIB, K2_FP32_CONTRIB - 16),
                  "no_reduce": (K2_SFU_CONTRIB, K2_FP32_CONTRIB),
                  "walk_only": (1, 2)}


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
    from horizongs_tpu_torch.tools.timing import best_ms
    return best_ms(fn, reps, rounds=1)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])


def _profile_report(p):
    """A `tools.timing.device_profile` reading of one call: wall ms,
    device-busy ms, idle share and the eight kernels with the most device
    time."""
    top = sorted(p["by_name"].items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": p["wall_ms"], "device_busy_ms": p["busy_ms"],
            "device_idle_share": 1 - p["busy_ms"] / p["wall_ms"],
            "top_kernels_ms": top}


def _compare_k1(kern, plain, atol, k_args):
    """Max errors of K1 against its plain version, and the tolerance check:
    acc rgb/alpha rows within `atol`, the depth row within `atol` + rtol
    2e-4 (values ~scene depth, f32 summation noise), exp(logT) atol 1e-4 (a
    pixel's final T is below 1e-4 either way once it stopped), i_fin
    within 1 chunk, n_contrib equal or at the stop
    (`raster3d.n_contrib_off_the_stop`)."""
    import torch
    from horizongs_tpu_torch.ops.raster3d import n_contrib_off_the_stop
    (acc_k, lt_k, nc_k), (acc_p, lt_p, nc_p) = kern, plain
    rows = [0, 1, 2, 4]
    err_rows = (acc_k[:, rows] - acc_p[:, rows]).abs().max().item()
    d_err = (acc_k[:, 3] - acc_p[:, 3]).abs()
    err_depth = d_err.max().item()
    depth_ok = bool((d_err <= atol + 2e-4 * acc_p[:, 3].abs()).all())
    err_T = (torch.exp(lt_k[:, 0]) - torch.exp(lt_p[:, 0])).abs().max().item()
    fin_diff = (lt_k[:, 1, 0] - lt_p[:, 1, 0]).abs()
    n_off = n_contrib_off_the_stop(*k_args[:4], nc_k, lt_k[:, 0], nc_p,
                                   lt_p[:, 0])
    ok = err_rows <= atol and depth_ok and err_T <= 1e-4 \
        and bool((fin_diff <= 1).all()) and n_off == 0
    return ok, {"acc_rgb_alpha": err_rows, "acc_depth": err_depth,
                "T": err_T, "i_fin_mismatched_tiles": int((fin_diff > 0).sum()),
                "n_contrib_mismatched_pixels": int((nc_k != nc_p).sum()),
                "n_contrib_off_the_stop": n_off}


def _compare_k2(kern, plain):
    """K2 against its plain version: per field, the max error within
    K2_TOL x that field's max |grad| (atomics sum in no fixed order)."""
    err = (kern - plain).abs().amax(dim=0)
    scale = plain.abs().amax(dim=0)
    ok = bool((err <= K2_TOL * scale).all())
    return ok, {"max_abs_err": err.max().item(),
                "rel_err_per_field": (err / scale.clamp_min(1e-30)).tolist()}


def _walked_mask(n_gauss, gauss_id, tile_starts, n_contrib):
    """(N,) bool: gaussians inside some pixel's walked prefix."""
    import torch
    n_inst = int(tile_starts[-1])
    idx = torch.arange(n_inst, device=gauss_id.device, dtype=torch.int32)
    tile = torch.searchsorted(tile_starts, idx, right=True) - 1
    reach = n_contrib.amax(dim=1)[tile]
    inside = (idx - tile_starts[tile]) < reach
    walked = torch.zeros(n_gauss, dtype=torch.bool, device=gauss_id.device)
    walked[gauss_id[:n_inst][inside].long()] = True
    return walked


def _k12_counts(fields, gauss_id, tile_starts, n_tiles_x, n_contrib):
    """What K1's and K2's walks over these segments do, from the records
    `n_contrib` and the plain copies of their skip tests: pixel-gaussian
    pairs walked (each pixel's segment up to the gaussian after which its
    transmittance is at or below 1e-4, K1's work; K2 walks the same pairs
    back) and, of those, the pairs with alpha >= 1/255 (contributing);
    warp-gaussian steps (each warp of `raster3d.warp_of_pixel` visits the
    gaussians before its pixels' furthest n_contrib) and the share the
    support box culls; the walked pairs in steps that are not culled
    (tested), the share of them whose rounded sigma the rejection skips,
    and the rest (exact); and the lane efficiency, tested pairs over the
    pixel slots (64 a warp) of the steps not culled, beside that of the
    row map the kernels had before (every warp walking to the tile's
    furthest n_contrib: 1024 slots a gaussian)."""
    import torch
    from horizongs_tpu_torch.ops import raster3d
    from horizongs_tpu_torch.ops.reference import ALPHA_CUTOFF, MAX_ALPHA
    dev = fields.device
    lx, ly = raster3d.local_pixel_coords(dev)
    warp = raster3d.warp_of_pixel(dev)
    starts = tile_starts.tolist()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    contrib, steps, culled, tested, rejected, row_slots = (
        zero.clone() for _ in range(6))
    for t in range(len(starts) - 1):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        f = fields[gauss_id[s:e].long()]
        nc = n_contrib[t].long()
        pos = torch.arange(e - s, device=dev)[None, :]
        sigma = raster3d._sigma(f, t, n_tiles_x, lx, ly)[2]
        alpha = torch.clamp_max(f[None, :, 5] * torch.exp(-sigma), MAX_ALPHA)
        walked = pos < nc[:, None]
        contrib += (walked & (alpha >= ALPHA_CUTOFF)).sum()
        cull = raster3d.warp_cull(f, t, n_tiles_x)          # (16, count)
        reach = torch.zeros(raster3d.WARPS, dtype=torch.int64,
                            device=dev).scatter_reduce(0, warp, nc, "amax")
        visit = pos < reach[:, None]
        steps += visit.sum()
        culled += (visit & cull).sum()
        kept = walked & ~cull[warp]
        tested += kept.sum()
        rejected += (kept & (sigma > raster3d.skip_threshold(f[:, 5]))).sum()
        row_slots += raster3d.P * nc.max()
    walked_n = int(n_contrib.sum())
    steps, culled, tested = int(steps), int(culled), int(tested)
    slots = raster3d.P // raster3d.WARPS * (steps - culled)
    return {"walked_pairs": walked_n, "contributing_pairs": int(contrib),
            "warp_steps": steps, "culled_step_share": culled / steps,
            "rejected_share": int(rejected) / tested,
            "culled_pair_share": 1 - tested / walked_n,
            "tested_pairs": tested, "exact_pairs": tested - int(rejected),
            "lane_efficiency": tested / slots,
            "lane_efficiency_row_map": walked_n / int(row_slots)}


def _bound(t_bytes, t_sfu, t_fp32):
    bound_s = max(t_bytes, t_sfu, t_fp32)
    return bound_s * 1e3, ("bytes" if t_bytes >= max(t_sfu, t_fp32)
                           else "operations")


def _k12_bound(counts, n_bytes, contrib_ops, walked_all, contrib_all,
               sfu_rate, fp32_rate):
    """K1's or K2's bound from its `_k12_counts`: (ms, bound_by) of the
    work its walk needs given the skip tests (the pairs in steps not culled
    tested, the exp for the pairs not rejected, `contrib_ops` (SFU, FP32)
    per contributing pair), and the ms of the count used before the skip
    tests: `walked_all` per walked and `contrib_all` per contributing
    pair."""
    walked, contrib = counts["walked_pairs"], counts["contributing_pairs"]
    tested, exact = counts["tested_pairs"], counts["exact_pairs"]
    need = _bound(n_bytes / HBM_BYTES_PER_S,
                  (K12_SFU_EXACT * exact + contrib_ops[0] * contrib)
                  / sfu_rate,
                  (K12_FP32_TESTED * tested + K12_FP32_EXACT * exact
                   + contrib_ops[1] * contrib) / fp32_rate)
    all_exact, _ = _bound(n_bytes / HBM_BYTES_PER_S,
                          (walked_all[0] * walked + contrib_all[0] * contrib)
                          / sfu_rate,
                          (walked_all[1] * walked + contrib_all[1] * contrib)
                          / fp32_rate)
    return need, all_exact


def _k34_bound(counts, n_bytes, sfu_walked, fp32_walked, sfu_contrib,
               fp32_contrib, sfu_rate, fp32_rate):
    """K3's or K4's bound from its `_k34_counts`: (ms, bound_by) of the work
    its walk needs given the skip tests (the pairs in steps not culled
    tested, the pairs not rejected intersected exactly, the contributing
    pairs' work), and the ms of the same walk with every walked pair
    intersected exactly (the per-walked-pair constants)."""
    walked, contrib = counts["walked_pairs"], counts["contributing_pairs"]
    tested, exact = counts["tested_pairs"], counts["exact_pairs"]
    need = _bound(n_bytes / HBM_BYTES_PER_S,
                  (K34_SFU_EXACT * exact + sfu_contrib * contrib) / sfu_rate,
                  (K34_FP32_TESTED * tested + K34_FP32_EXACT * exact
                   + fp32_contrib * contrib) / fp32_rate)
    all_exact, _ = _bound(n_bytes / HBM_BYTES_PER_S,
                          (sfu_walked * walked + sfu_contrib * contrib)
                          / sfu_rate,
                          (fp32_walked * walked + fp32_contrib * contrib)
                          / fp32_rate)
    return need, all_exact


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


def _surfel_scene(dev):
    """`_kernel_scene` (a cloud, a saturated stack, duplicate means, empty
    border tiles) as surfels, plus the cases K3 and K4 branch on: 200
    surfels within a tenth of a degree of edge-on to the view (|k_z| near
    0 where a ray runs along the plane, hits near or behind the camera,
    z <= 0.01, where it crosses it; the screen-space low-pass gives their
    alpha) and a faint patch of 24 (pixels that never cross T = 0.5)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)

    def block(means, angles, scales, opacities):
        n = len(means)
        half = np.asarray(angles) / 2
        quats = np.stack([np.cos(half), np.sin(half), np.zeros(n),
                          np.zeros(n)], axis=1)          # about the x axis
        return {"means": means, "quats": quats,
                "scales": np.repeat(np.asarray(scales)[:, None], 3, axis=1),
                "opacities": np.asarray(opacities),
                "colors": rng.uniform(0, 1, (n, 3))}

    n = 200
    edge_on = block(np.stack([rng.uniform(-0.6, 0.6, n),
                              rng.uniform(-0.02, 0.02, n),
                              rng.uniform(-0.5, 0.5, n)], axis=1),
                    np.radians(90 + rng.uniform(-0.1, 0.1, n)),
                    rng.uniform(0.1, 0.2, n), np.full(n, 0.9))
    faint = block(np.stack([rng.uniform(1.2, 1.6, 24),
                            rng.uniform(1.2, 1.6, 24),
                            rng.uniform(-0.2, 0.2, 24)], axis=1),
                  rng.uniform(0, np.pi, 24), rng.uniform(0.1, 0.2, 24),
                  np.full(24, 0.1))
    base = {k: v.cpu().numpy() for k, v in _kernel_scene("cpu").items()}
    return {k: torch.from_numpy(np.concatenate(
        [base[k], edge_on[k], faint[k]]).astype(np.float32)).to(
            dev) for k in base}


def _surfel_cases(fields, gauss_id, tile_starts, n_tiles_x, acc, rec):
    """What a K3/K4 comparison covered: walked pairs with alpha >= 1/255
    through the screen-space low-pass (no 3D hit), of those the ones with
    |k_z| below 1% of |k| (the ray within 0.6 degrees of the plane), pairs
    cut only by the hit
    depth z <= 0.01, and pixels with alpha > 0 that never cross T = 0.5."""
    import torch
    from horizongs_tpu_torch.ops import raster2d
    lx, ly = raster2d.local_pixel_coords(fields.device)
    starts = tile_starts.tolist()
    low_pass = edge_on = behind = 0
    for t in range(len(starts) - 1):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        geo = raster2d.segment_geometry(fields[gauss_id[s:e].long()], t,
                                        n_tiles_x, lx, ly)
        walked = (torch.arange(e - s, device=fields.device)[None, :]
                  < rec[t, 0][:, None])
        hit = walked & (geo["alpha"] > 0)
        kx, ky = geo["u"] * geo["kzs"], geo["v"] * geo["kzs"]
        k = torch.sqrt(kx * kx + ky * ky + geo["kzs"] * geo["kzs"])
        low_pass += int((hit & ~geo["use3d"]).sum())
        edge_on += int((hit & (geo["kzs"].abs() < 1e-2 * k)).sum())
        alpha = torch.clamp_max(geo["raw"], 0.999)
        behind += int((walked & (alpha >= 1 / 255)
                       & (geo["z"] <= 0.01)).sum())
    never = int(((rec[:, 1] < 0) & (acc[:, 6] > 0)).sum())
    return {"low_pass_pairs": low_pass, "edge_on_pairs": edge_on,
            "pairs_cut_by_z": behind, "pixels_never_crossing_half": never}


def _compare_k3(kern, plain, atol, k_args):
    """Max errors of K3 against its plain version, and the tolerance check:
    the acc rows (rgb, normal, alpha) within `atol`; D within `atol` + rtol
    2e-4; the distortion within `atol` + 2e-4 x (|distortion| + D) (its
    terms are of the size of D, summed in other orders); exp(log T) atol
    1e-4; the median depth equal where both name the same surfel; n_contrib
    and the median's position equal or at a boundary that rounding moves
    (`raster2d.records_off_the_boundary`)."""
    import torch
    from horizongs_tpu_torch.ops.raster2d import records_off_the_boundary
    (acc_k, aux_k, rec_k), (acc_p, aux_p, rec_p) = kern, plain
    err_acc = (acc_k - acc_p).abs().max().item()
    D_p = aux_p[:, 1].abs()
    d_err = (aux_k[:, 1] - aux_p[:, 1]).abs()
    x_err = (aux_k[:, 2] - aux_p[:, 2]).abs()
    err_T = (torch.exp(aux_k[:, 0]) - torch.exp(aux_p[:, 0])).abs().max().item()
    same = rec_k[:, 1] == rec_p[:, 1]
    med_err = (aux_k[:, 3] - aux_p[:, 3]).abs()[same].max().item()
    off = records_off_the_boundary(*k_args[:4], rec_k, aux_k[:, 0], rec_p,
                                   aux_p[:, 0])
    ok = (err_acc <= atol and bool((d_err <= atol + 2e-4 * D_p).all())
          and bool((x_err <= atol + 2e-4 * (aux_p[:, 2].abs() + D_p)).all())
          and err_T <= 1e-4 and med_err <= atol and off == (0, 0))
    return ok, {"acc": err_acc, "D": d_err.max().item(),
                "distortion": x_err.max().item(), "T": err_T,
                "median_same_surfel": med_err,
                "n_contrib_mismatched_pixels":
                    int((rec_k[:, 0] != rec_p[:, 0]).sum()),
                "median_mismatched_pixels": int((~same).sum()),
                "records_off_the_boundary": list(off)}


def _k34_counts(fields, gauss_id, tile_starts, n_tiles_x, rec):
    """What K3's and K4's walks over these segments do, from the records
    `rec` and the plain copies of their skip tests: pixel-surfel pairs
    walked (each pixel's segment up to its stop, K3's work; K4 walks the
    same pairs back) and, of those, the pairs with alpha > 0; warp-surfel
    steps (each warp of `raster2d.warp_of_pixel` visits the surfels before
    its pixels' furthest n_contrib) and the share the support box culls;
    the walked pairs in steps that are not culled (tested), the share of
    them that the division-free test rejects, and the rest (intersected
    exactly); and the lane efficiency, walked pairs over the pixel slots
    (64 a warp) of the steps issued, beside that of a row map with no
    per-warp exit (two pixel rows a warp, every warp walking to
    the tile's furthest n_contrib: 512 slots a surfel)."""
    import torch
    from horizongs_tpu_torch.ops import raster2d
    dev = fields.device
    lx, ly = raster2d.local_pixel_coords(dev)
    warp = raster2d.warp_of_pixel(dev)
    starts = tile_starts.tolist()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    contrib, steps, culled, issued, rejected, row_slots = (
        zero.clone() for _ in range(6))
    for t in range(len(starts) - 1):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        f = fields[gauss_id[s:e].long()]
        nc = rec[t, 0].long()
        pos = torch.arange(e - s, device=dev)[None, :]
        alpha = raster2d.segment_geometry(f, t, n_tiles_x, lx, ly)["alpha"]
        walked = pos < nc[:, None]
        contrib += (walked & (alpha > 0)).sum()
        cull = raster2d.warp_cull(f, t, n_tiles_x)           # (8, count)
        reach = torch.zeros(raster2d.WARPS, dtype=torch.int64,
                            device=dev).scatter_reduce(0, warp, nc, "amax")
        visit = pos < reach[:, None]
        steps += visit.sum()
        culled += (visit & cull).sum()
        kept = walked & ~cull[warp]
        issued += kept.sum()
        rejected += (kept & raster2d.segment_reject(f, t, n_tiles_x, lx,
                                                    ly)).sum()
        row_slots += raster2d.P * nc.max()
    walked_n = int(rec[:, 0].sum())
    steps, culled, issued = int(steps), int(culled), int(issued)
    return {"walked_pairs": walked_n, "contributing_pairs": int(contrib),
            "warp_steps": steps, "culled_step_share": culled / steps,
            "rejected_share": int(rejected) / issued,
            "culled_pair_share": 1 - issued / walked_n,
            "tested_pairs": issued, "exact_pairs": issued - int(rejected),
            "lane_efficiency": issued / (64 * (steps - culled)),
            "lane_efficiency_row_map": walked_n / int(row_slots)}


def _ptxas(log, kernel):
    """Registers, static shared bytes and spill bytes that ptxas reported
    for the entry function `kernel` in a build log (None where the library
    was already built and no log was kept)."""
    import re
    for part in log.split("Compiling entry function")[1:]:
        if kernel not in part.splitlines()[0]:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        smem = re.search(r"(\d+) bytes smem", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        return {"registers": int(regs.group(1)) if regs else None,
                "shared_bytes": int(smem.group(1)) if smem else 0,
                "spill_bytes": (int(spill.group(1)) + int(spill.group(2))
                                if spill else 0)}
    return {"registers": None, "shared_bytes": None, "spill_bytes": None}


def _flat_leaves(tree, prefix=""):
    """Nested dicts of arrays and numbers (`convert.train_state_to_numpy`)
    -> (dotted name, array) pairs."""
    import numpy as np
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}{key}.")
        elif v is not None:
            yield f"{prefix}{key}", np.asarray(v)


def _counts(kernels):
    return tuple(k.launches for k in kernels)


def _reset(kernels):
    for k in kernels:
        k.launches = 0


def _serve(cams, cfg, mlps, state, bg, cap, build, fwd, kernels, expect):
    """Requests through `render(rasterizer="cuda")`, each timed on the host
    clock after one warm-up pass, with every kernel's count set to 0 just
    before and read just after (they must equal `expect`); all outputs
    finite, nothing dropped; then the device time of each layer (CUDA
    events around decode, projection + binning (`build`) and the forward
    kernel (`fwd`)) and one profiled request."""
    import torch
    from horizongs_tpu_torch.render import decode_view, render
    from horizongs_tpu_torch.tools.timing import device_profile
    W, H = cams[0].width, cams[0].height
    for c in cams:                                   # warm-up
        render(c, cfg, mlps, state, bg, instance_cap=cap)
    torch.cuda.synchronize()
    _reset(kernels)
    view_ms, pkgs = [], []
    for c in cams:
        t0 = time.perf_counter()
        pkg = render(c, cfg, mlps, state, bg, rasterizer="cuda",
                     instance_cap=cap)
        torch.cuda.synchronize()
        view_ms.append((time.perf_counter() - t0) * 1e3)
        pkgs.append(pkg)
    launches = _counts(kernels)
    _require(launches == expect,
             f"K1-K4 launched {launches} times for {len(cams)} requests "
             f"of gs_attr {cfg.gs_attr}, expected {expect}")
    for pkg in pkgs:
        _require(pkg["render"].shape == (H, W, 3), "render shape")
        for key, x in pkg.items():
            if key.startswith("render") and x is not None:
                _require(bool(torch.isfinite(x).all()), f"{key} finite")
        _require(int(pkg["n_dropped"]) == 0, "instances dropped")
    stages = {"decode": [], "project_bin": [], "kernel": []}
    for c in cams:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        dec = decode_view(c, cfg, mlps, state)
        ev[1].record()
        ri = build(dec.means, dec.quats, dec.scales, dec.opacities,
                   dec.colors, c.viewmat, c.K, W, H, cap=cap)
        ev[2].record()
        fwd(ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            ri.grid.n_tiles_x, ri.grid.n_tiles_y)
        ev[3].record()
        ev[3].synchronize()
        for i, k in enumerate(stages):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
    prof = device_profile(
        lambda: render(cams[0], cfg, mlps, state, bg, instance_cap=cap))
    return {"view_ms": view_ms, "pkgs": pkgs, "launches": launches,
            "stages": stages, "prof": prof}


def _train(cfg, opt, state, mlps, cam, bg, cap, live, bwd_name, kernels,
           expect):
    """2 warm-up and 20 timed steps of `build_train_step(cfg, opt)` at the
    camera's size towards the model rendered with feat from seed 1, each
    timed on the host clock, with every kernel's count set to 0 just before
    the timed steps and read after (they must equal `expect` per step).
    The loss must be finite and lower at the end, parameters and moments
    finite, statistics gathered, nothing dropped. The backward wrapper
    `raster_cuda.<bwd_name>`'s inputs in the first timed step are copied in
    an untimed forward and backward of that step's state and iteration.
    Then the device time of forward, backward and update and one profiled
    step. The decoders are copied: a step updates them in place. Returns
    the timings, the captured inputs, and the final state, camera and
    iteration."""
    import copy
    import torch
    from horizongs_tpu_torch.ops import raster_cuda
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.render import count_render_instances, render
    from horizongs_tpu_torch.tools.timing import device_profile
    from horizongs_tpu_torch.train.step import (
        build_train_step, camera_tensors, init_train_state)
    n_warm, n_steps = 2, 20
    feat1 = torch.randn(state.feat.shape,
                        generator=torch.Generator().manual_seed(1)) * live
    target_state = state._replace(feat=feat1.to(state.feat.device))
    with torch.no_grad():
        cap_t = suggest_instance_cap(count_render_instances(
            cam, cfg, mlps, target_state), margin=1.15)
        target = render(cam, cfg, mlps, target_state, bg,
                        instance_cap=cap_t)["render"]
    step = build_train_step(cfg, opt, cam.height, cam.width,
                            add_prefilter=True, rasterizer="cuda",
                            instance_cap=cap)
    ts = init_train_state(state, copy.deepcopy(mlps))
    ct = camera_tensors(cam, image=target, do_stats=True)
    losses, step_ms, dropped = [], [], []
    it = 0
    for _ in range(n_warm):
        it += 1
        ts, m = step(ts, ct, it)
        losses.append(float(m["loss"]))
        dropped.append(int(m["n_dropped"]))
    captured = []
    bwd = getattr(raster_cuda, bwd_name)

    def capture(*args):
        captured.append(tuple(a.detach().clone() if torch.is_tensor(a)
                              else a for a in args))
        return bwd(*args)

    setattr(raster_cuda, bwd_name, capture)
    try:
        step.value_and_grad(ts, ct, float(it + 1))
    finally:
        setattr(raster_cuda, bwd_name, bwd)
    _require(len(captured) == 1,
             f"{bwd_name} called {len(captured)} times in a step")
    torch.cuda.synchronize()

    _reset(kernels)
    for _ in range(n_steps):
        it += 1
        t0 = time.perf_counter()
        ts, m = step(ts, ct, it)
        loss = float(m["loss"])                       # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        dropped.append(int(m["n_dropped"]))
    launches = _counts(kernels)
    _require(launches == tuple(n_steps * e for e in expect),
             f"K1-K4 launched {launches} times in {n_steps} steps of "
             f"gs_attr {cfg.gs_attr}")
    _require(all(math.isfinite(x) for x in losses), f"loss {losses}")
    _require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    _require(max(dropped) == 0, f"instances dropped: {dropped}")
    for name, group in ts.params.groups().items():
        for i, t in enumerate(group):
            for what, x in (("param", t), ("mu", ts.opt.mu[name][i]),
                            ("nu", ts.opt.nu[name][i])):
                _require(bool(torch.isfinite(x).all()),
                         f"{what} {name}[{i}] finite")
    _require(float(ts.stats.anchor_demon.sum()) > 0
             and float(ts.stats.offset_denom.sum()) > 0,
             "densification statistics gathered")
    last_metrics = {k: float(v) for k, v in m.items()}

    split = {"forward": [], "backward": [], "update": []}
    for _ in range(4):
        it += 1
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss_t, aux, pkg, probe = step.forward(ts, ct, it)
        ev[1].record()
        grads, probe_grad = step.backward(ts, loss_t, probe)
        ev[2].record()
        ts, m = step.update(ts, ct, it, loss_t.detach(), aux, pkg, grads,
                            probe_grad)
        ev[3].record()
        ev[3].synchronize()
        for i, k in enumerate(split):
            split[k].append(ev[i].elapsed_time(ev[i + 1]))
    box = [ts]

    def one_step():
        box[0], _ = step(box[0], ct, it + 1)
    prof = device_profile(one_step)
    return {"losses": losses, "step_ms": step_ms, "launches": launches,
            "last_metrics": last_metrics, "split": split, "prof": prof,
            "captured": captured[0], "n_steps": n_steps, "n_warm": n_warm,
            "state": box[0], "camera": ct, "iteration": it + 1}


def _slice_report(name, card, tr, cap):
    return {"slice": name, "card": card, "steps": tr["n_steps"],
            "warmup_steps": tr["n_warm"], "step_ms": tr["step_ms"],
            "step_ms_p50": _median(tr["step_ms"]),
            "step_ms_min": min(tr["step_ms"]),
            "step_ms_max": max(tr["step_ms"]), "losses": tr["losses"],
            "last_metrics": tr["last_metrics"], "instance_cap": cap,
            "stages_ms_p50": {k: _median(v) for k, v in tr["split"].items()},
            "profiled_step": _profile_report(tr["prof"])}


def _serve_report(sv, card):
    return {"stages_ms_p50": {k: _median(v) for k, v in sv["stages"].items()},
            "profiled_request": _profile_report(sv["prof"]), "card": card}


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

    from horizongs_tpu_torch.config import make_optim
    from horizongs_tpu_torch.data.synthetic import (
        lookat_camera, orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.device import disable_tf32
    from horizongs_tpu_torch.models.anchors import init_anchor_state_from_points
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.ops import (
        grid_overhead, raster2d, raster3d, raster_cuda)
    from horizongs_tpu_torch.ops.raster_cuda import (
        build_raster_inputs, build_raster_inputs_2dgs, count_instances_2dgs,
        suggest_instance_cap)
    from horizongs_tpu_torch.render import (
        count_render_instances, decode_view, render)
    K1, K2 = raster3d.KERNEL, raster3d.KERNEL_BWD
    K3, K4 = raster2d.KERNEL_2D, raster2d.KERNEL_2D_BWD
    T1, T2 = raster3d.KERNEL_PERSISTENT, raster3d.KERNELS_BWD_VARIANT
    T3 = grid_overhead.KERNELS
    TOOLS = (T1, *T2.values(), *T3.values())
    ALL = (K1, K2, K3, K4, *TOOLS)
    NO_TOOLS = (0,) * len(TOOLS)

    # 1. device --------------------------------------------------------------
    card = _smi("name,power.limit")
    print(f"device: {card}", flush=True)
    sm_clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    sfu_rate = SFU_OPS_PER_SM_CLK * n_sm * sm_clock_hz
    fp32_rate = FP32_OPS_PER_SM_CLK * n_sm * sm_clock_hz
    disable_tf32()
    torch.set_grad_enabled(False)   # serving is forward only; 6. turns it on

    # 2. build: one nvcc per library, started together --------------------
    to_build = {"K1": K1, "K2": K2, "K3": K3, "K4": K4, "T1": T1,
                **{f"T2 {v}": T2[v] for v in raster3d.VARIANTS[1:]},
                "T3": T3["empty"]}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(to_build)) as pool:
        built = dict(zip(to_build, pool.map(lambda k: k.build(),
                                            to_build.values())))
    print(f"build K1-K4, T1-T3: {time.perf_counter() - t0:.2f} s")
    for label, b in built.items():
        print(f"build {label}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3a. K1, K2 vs plain on a small scene -----------------------------------
    g = _kernel_scene(dev)
    cam = lookat_camera(width=256, height=256, eye=(0, 0, -4), device=dev)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             256, 256)
    counts = ri.inst.tile_starts.diff()
    _require(int(ri.inst.n_dropped) == 0, "instances dropped")
    k_args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
              ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    k1_args_256 = k_args                              # T1 is held to K1 here
    kern = raster3d.rasterize_fwd(*k_args)
    torch.cuda.synchronize()
    ok, errs = _compare_k1(kern, raster3d.rasterize_fwd_plain(*k_args),
                           2e-5, k_args)
    n_sat = int((kern[1][:, 1, 0] * raster3d.G < counts.float()).sum())
    print(f"K1 vs plain 256x256: {int(ri.inst.n_instances)} instances, "
          f"{int((counts == 0).sum())} empty tiles, {n_sat} tiles stopped "
          f"early; errors {json.dumps(errs)}")
    _require(ok, "K1 disagrees with its plain version")
    gen = torch.Generator().manual_seed(2)
    n_tiles = ri.grid.n_tiles
    d_acc = torch.randn((n_tiles, raster3d.N_ACC, raster3d.P),
                        generator=gen).to(dev)
    d_logT = torch.randn((n_tiles, raster3d.P), generator=gen).to(dev)
    b_args = (*k_args[:3], d_acc, d_logT, kern[1][:, 0].contiguous(),
              kern[2], *k_args[3:])
    grad_k = raster3d.rasterize_bwd(*b_args)
    torch.cuda.synchronize()
    ok, errs2 = _compare_k2(grad_k, raster3d.rasterize_bwd_plain(*b_args))
    walked = _walked_mask(ri.fields.shape[0], *k_args[1:3], kern[2])
    n_unwalked = int((~walked).sum())
    zeros_ok = bool((grad_k[~walked] == 0).all())
    print(f"K2 vs plain 256x256: {int(walked.sum())} gaussians walked, "
          f"{n_unwalked} not (exact zeros: {zeros_ok}); errors "
          f"{json.dumps(errs2)}")
    _require(ok, "K2 disagrees with its plain version")
    _require(zeros_ok and n_unwalked > 0,
             "K2 wrote gradient for gaussians no pixel walked")

    # 3b. K3, K4 vs plain on a small surfel scene ----------------------------
    g = _surfel_scene(dev)
    cap_k = suggest_instance_cap(int(count_instances_2dgs(
        g["means"], g["quats"], g["scales"], g["opacities"], cam.viewmat,
        cam.K, 256, 256)), margin=1.15)
    ri = build_raster_inputs_2dgs(g["means"], g["quats"], g["scales"],
                                  g["opacities"], g["colors"], cam.viewmat,
                                  cam.K, 256, 256, cap=cap_k)
    counts = ri.inst.tile_starts.diff()
    _require(int(ri.inst.n_dropped) == 0, "instances dropped")
    k_args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
              ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    kern = raster2d.rasterize2d_fwd(*k_args)
    torch.cuda.synchronize()
    ok, errs = _compare_k3(kern, raster2d.rasterize2d_fwd_plain(*k_args),
                           2e-5, k_args)
    cases = _surfel_cases(*k_args[:4], kern[0], kern[2])
    cases["empty_tiles"] = int((counts == 0).sum())
    cases["stopped_pixels"] = int((kern[1][:, 0] <= raster2d.LOG_T_EPS).sum())
    print(f"K3 vs plain 256x256: {int(ri.inst.n_instances)} instances, "
          f"cases {json.dumps(cases)}; errors {json.dumps(errs)}")
    _require(ok, "K3 disagrees with its plain version")
    _require(min(cases.values()) > 0, f"a case is missing: {cases}")
    gen = torch.Generator().manual_seed(3)
    n_tiles = ri.grid.n_tiles
    d_acc = torch.randn((n_tiles, raster2d.N_ACC, raster2d.P),
                        generator=gen).to(dev)
    d_aux = torch.randn((n_tiles, raster2d.N_AUX, raster2d.P),
                        generator=gen).to(dev)
    b_args = (*k_args[:3], d_acc, d_aux, *kern, *k_args[3:])
    grad_k = raster2d.rasterize2d_bwd(*b_args)
    torch.cuda.synchronize()
    ok, errs2 = _compare_k2(grad_k, raster2d.rasterize2d_bwd_plain(*b_args))
    walked = _walked_mask(ri.fields.shape[0], *k_args[1:3], kern[2][:, 0])
    n_unwalked = int((~walked).sum())
    zeros_ok = bool((grad_k[~walked] == 0).all())
    print(f"K4 vs plain 256x256: {int(walked.sum())} surfels walked, "
          f"{n_unwalked} not (exact zeros: {zeros_ok}); errors "
          f"{json.dumps(errs2)}")
    _require(ok, "K4 disagrees with its plain version")
    _require(zeros_ok and n_unwalked > 0,
             "K4 wrote gradient for surfels no pixel walked")

    # the flagship LOD model, 3DGS and 2DGS ---------------------------------
    W, H, n_views, n_views_2d = 1920, 1088, 8, 4
    cfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                      view_dim=3, color_attr="RGB", render_mode="RGB+ED",
                      voxel_size=0.02, fork=2, aerial_levels=2,
                      street_levels=4, standard_dist=8.0)
    cfg2d = ModelConfig(**{**cfg.__dict__, "gs_attr": "2D"})
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
    cams2d = cams[::n_views // n_views_2d]
    bg = torch.zeros(3, device=dev)
    small = orbit_cameras(1, radius=3.5, height_z=-1.0, width=256,
                          height=256, device=dev)[0]

    # 4. serving 3DGS: 8 requests at 1920x1088 -------------------------------
    n_inst = [count_render_instances(c, cfg, mlps, state) for c in cams]
    cap = suggest_instance_cap(max(n_inst), margin=1.15)
    sv = _serve(cams, cfg, mlps, state, bg, cap, build_raster_inputs,
                raster3d.rasterize_fwd, ALL, (n_views, 0, 0, 0, *NO_TOOLS))
    alpha_mean = sum(float(p["render_alphas"].mean())
                     for p in sv.pop("pkgs")) / n_views
    p50 = _median(sv["view_ms"])

    # one 256x256 view against the dense oracle
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
    k1_args_1080 = k_args
    kern = raster3d.rasterize_fwd(*k_args)
    plain = raster3d.rasterize_fwd_plain(*k_args)
    torch.cuda.synchronize()
    # the plain version's cumsum on the card sums log T in another order
    # than the kernel's walk, so over 2M pixels a gaussian at the T = 1e-4
    # stop may fall the other way: it is worth at most alpha * 1e-4
    ok, k1_errs = _compare_k1(kern, plain, 1e-4, k_args)
    print(f"K1 vs plain 1920x1088: errors {json.dumps(k1_errs)}")
    _require(ok, "K1 disagrees with its plain version at 1080p")
    k1_ms = _time_ms(lambda: raster3d.rasterize_fwd(*k_args), 20)
    k1_plain_ms = _time_ms(lambda: raster3d.rasterize_fwd_plain(*k_args), 1)
    k1_counts = _k12_counts(*k_args[:4], plain[2])
    k1_inst = int(ri.inst.n_instances)
    n_pix = ri.grid.n_tiles * raster3d.P
    # fields, ids and tile starts read once; acc, log T / i_fin, n_contrib
    # written once
    k1_bytes = (ri.fields.numel() * 4 + k1_inst * 4
                + ri.inst.tile_starts.numel() * 4 + n_pix * 8 * 4)
    (k1_bound_ms, k1_bound_by), k1_all_exact_ms = _k12_bound(
        k1_counts, k1_bytes, (K1_SFU_CONTRIB, K1_FP32_CONTRIB),
        (1, FP32_OPS_PER_PAIR), (0, 0), sfu_rate, fp32_rate)
    k1_design = {**_ptxas(built["K1"].log, "raster3d_fwd_kernel"),
                 "blocks_per_sm": raster3d.occupancy(0),
                 "bound_share": k1_bound_ms / k1_ms,
                 "bound_ms_all_exact": k1_all_exact_ms,
                 "bound_share_all_exact": k1_all_exact_ms / k1_ms,
                 **k1_counts}
    print(f"K1 1920x1088: {k1_ms:.4f} ms, bound {k1_bound_ms:.4f} ms; "
          f"design {json.dumps(k1_design)}")

    # 5. serving 2DGS: 4 requests at 1920x1088 -------------------------------
    n_inst2 = [count_render_instances(c, cfg2d, mlps, state) for c in cams2d]
    cap2 = suggest_instance_cap(max(n_inst2), margin=1.15)
    sv2 = _serve(cams2d, cfg2d, mlps, state, bg, cap2,
                 build_raster_inputs_2dgs, raster2d.rasterize2d_fwd, ALL,
                 (0, 0, n_views_2d, 0, *NO_TOOLS))
    alpha_mean2 = sum(float(p["render_alphas"].mean())
                      for p in sv2.pop("pkgs")) / n_views_2d

    # one 256x256 view against the 2DGS dense oracle. The reference's 2DGS
    # binning bounds a surfel by the circle of radius max(AABB half
    # extents), which misses the ends of a disk seen tilted along a
    # diagonal (they reach sqrt(hx^2 + hy^2)), so the cuda path is held to
    # the oracle with every visible surfel binned into every tile: images,
    # alphas and normals atol 2e-4, ED depth + rtol 2e-4, distortion
    # 5e-4 + 2e-4 x (|dist| + D); the median off by more than 1e-4 + rtol
    # 2e-4 on at most 0.05% of the pixels (a T = 0.5 crossing that the
    # oracle's product and K3's log sum place on neighbouring surfels), and
    # the normals from it within 5e-4 outside those pixels' 3x3
    # neighbourhoods. The binned path's distance from the oracle is
    # reported beside it.
    out_d = render(small, cfg2d, mlps, state, bg, rasterizer="dense")
    cull = raster_cuda._cull_radii

    def everywhere(proj, opacities, guard_px=0.0):
        r = cull(proj, opacities, guard_px)
        return torch.where(r > 0, torch.full_like(r, 1e6), r)

    raster_cuda._cull_radii = everywhere
    try:
        n_all = count_render_instances(small, cfg2d, mlps, state)
        out_c = render(small, cfg2d, mlps, state, bg, rasterizer="cuda",
                       instance_cap=n_all)
    finally:
        raster_cuda._cull_radii = cull
    _require(int(out_c["n_dropped"]) == 0, "instances dropped")
    keys2 = ("render", "render_alphas", "render_depth", "render_normals",
             "render_distort", "render_median_depth",
             "render_normals_from_depth")
    diff = {k: (out_c[k] - out_d[k]).abs() for k in keys2}
    med_d = out_d["render_median_depth"]
    med_off = (diff["render_median_depth"]
               > 1e-4 + 2e-4 * med_d.abs())[..., 0]
    near_off = torch.nn.functional.max_pool2d(
        med_off[None, None].float(), 3, stride=1, padding=1)[0, 0] > 0
    depth_sum = out_d["render_depth"] * out_d["render_alphas"]
    dense2_ok = (
        all(float(diff[k].max()) <= 2e-4 for k in
            ("render", "render_alphas", "render_normals"))
        and bool((diff["render_depth"]
                  <= 2e-4 + 2e-4 * out_d["render_depth"].abs()).all())
        and bool((diff["render_distort"] <= 5e-4 + 2e-4 * (
            out_d["render_distort"].abs() + depth_sum)).all())
        and int(med_off.sum()) <= 5e-4 * med_off.numel()
        and float(diff["render_normals_from_depth"][~near_off].max())
        <= 5e-4)
    dense2_err = {k: float(v.max()) for k, v in diff.items()}
    dense2_err["median_off_pixels"] = int(med_off.sum())
    cap_s2 = suggest_instance_cap(
        count_render_instances(small, cfg2d, mlps, state), margin=1.15)
    out_b = render(small, cfg2d, mlps, state, bg, rasterizer="cuda",
                   instance_cap=cap_s2)
    binned_off = (out_b["render"] - out_d["render"]).abs().amax(-1) > 2e-4
    dense2_err["binned_render_err"] = float(
        (out_b["render"] - out_d["render"]).abs().max())
    dense2_err["binned_pixels_off_by_2e-4"] = int(binned_off.sum())
    print(f"cuda vs dense 256x256 2DGS ({n_all} instances, every surfel in "
          f"every tile): errors {json.dumps(dense2_err)}")
    _require(dense2_ok, "2DGS cuda path disagrees with the dense oracle")

    # K3 at the main path's shapes: the inputs of the first 2DGS request
    dec = decode_view(cams2d[0], cfg2d, mlps, state)
    ri = build_raster_inputs_2dgs(dec.means, dec.quats, dec.scales,
                                  dec.opacities, dec.colors,
                                  cams2d[0].viewmat, cams2d[0].K, W, H,
                                  cap=cap2)
    k_args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
              ri.grid.n_tiles_x, ri.grid.n_tiles_y)
    kern = raster2d.rasterize2d_fwd(*k_args)
    plain = raster2d.rasterize2d_fwd_plain(*k_args)
    torch.cuda.synchronize()
    ok, k3_errs = _compare_k3(kern, plain, 1e-4, k_args)
    print(f"K3 vs plain 1920x1088: errors {json.dumps(k3_errs)}")
    _require(ok, "K3 disagrees with its plain version at 1080p")
    k3_ms = _time_ms(lambda: raster2d.rasterize2d_fwd(*k_args), 20)
    k3_plain_ms = _time_ms(lambda: raster2d.rasterize2d_fwd_plain(*k_args), 1)
    k3_counts = _k34_counts(*k_args[:4], plain[2])
    k3_inst = int(ri.inst.n_instances)
    n_pix2 = ri.grid.n_tiles * raster2d.P
    # fields, ids and tile starts read once; acc (7 rows), aux (4) and the
    # two int32 records written once: 52 B per pixel
    k3_bytes = (ri.fields.numel() * 4 + k3_inst * 4
                + ri.inst.tile_starts.numel() * 4 + n_pix2 * 52)
    (k3_bound_ms, k3_bound_by), k3_all_exact_ms = _k34_bound(
        k3_counts, k3_bytes, K3_SFU_WALKED, K3_FP32_WALKED, K3_SFU_CONTRIB,
        K3_FP32_CONTRIB, sfu_rate, fp32_rate)
    k3_design = {**_ptxas(built["K3"].log, "raster2d_fwd_kernel"),
                 "blocks_per_sm": raster2d.occupancy("raster2d_fwd", 0),
                 "bound_share": k3_bound_ms / k3_ms,
                 "bound_ms_all_exact": k3_all_exact_ms,
                 "bound_share_all_exact": k3_all_exact_ms / k3_ms,
                 **k3_counts}
    print(f"K3 1920x1088: {k3_ms:.4f} ms, bound {k3_bound_ms:.4f} ms; "
          f"design {json.dumps(k3_design)}")

    # 6. training 3DGS: 2 + 20 steps at 1920x1088 ---------------------------
    torch.set_grad_enabled(True)
    # update_interval, success_threshold and min_opacity are read by
    # densification only (phase 9): with 20 and 0.5, 22 steps pass its
    # statistics gates; with random weights an anchor's mean opacity is
    # rarely below the default 0.005, so anchors below 0.1 are pruned
    opt3d = make_optim(start_stat=0, update_interval=20,
                       success_threshold=0.5, min_opacity=0.1)
    tr = _train(cfg, opt3d, state, mlps, cams[0], bg, cap, live,
                "rasterize_bwd", ALL, (1, 1, 0, 0, *NO_TOOLS))
    # K2 at the main path's shapes: the first timed step's inputs
    b_args = tr.pop("captured")
    k2_args_1080 = b_args
    f, gid, starts, ntx, nty = (b_args[0], b_args[1], b_args[2], b_args[7],
                                b_args[8])
    grad_k = raster3d.rasterize_bwd(*b_args)
    grad_p = raster3d.rasterize_bwd_plain(*b_args)
    torch.cuda.synchronize()
    ok, k2_errs = _compare_k2(grad_k, grad_p)
    walked = _walked_mask(f.shape[0], gid, starts, b_args[6])
    zeros_ok = bool((grad_k[~walked] == 0).all())
    print(f"K2 vs plain 1920x1088: {int(walked.sum())} gaussians walked "
          f"(exact zeros elsewhere: {zeros_ok}); errors {json.dumps(k2_errs)}")
    _require(ok, "K2 disagrees with its plain version at 1080p")
    _require(zeros_ok, "K2 wrote gradient for gaussians no pixel walked")
    k2_ms = _time_ms(lambda: raster3d.rasterize_bwd(*b_args), 20)
    k2_plain_ms = _time_ms(lambda: raster3d.rasterize_bwd_plain(*b_args), 1)
    k2_counts = _k12_counts(f, gid, starts, ntx, b_args[6])
    k2_inst = int(starts[-1])
    n_pix = ntx * nty * raster3d.P
    # fields, ids and tile starts read once, 32 B per pixel (d_acc, d_logT,
    # log T, n_contrib), the field gradient written once
    k2_bytes = (f.numel() * 4 * 2 + k2_inst * 4 + starts.numel() * 4
                + n_pix * 32)
    k2_contrib_ops = (K2_SFU_CONTRIB, K2_FP32_CONTRIB)
    (k2_bound_ms, k2_bound_by), k2_all_exact_ms = _k12_bound(
        k2_counts, k2_bytes, k2_contrib_ops, (K2_SFU_WALKED, K2_FP32_WALKED),
        k2_contrib_ops, sfu_rate, fp32_rate)
    k2_design = {**_ptxas(built["K2"].log, "raster3d_bwd_kernel"),
                 "blocks_per_sm": raster3d.variant_occupancy("full", 0)[1],
                 "bound_share": k2_bound_ms / k2_ms,
                 "bound_ms_all_exact": k2_all_exact_ms,
                 "bound_share_all_exact": k2_all_exact_ms / k2_ms,
                 **k2_counts}
    print(f"K2 1920x1088: {k2_ms:.4f} ms, bound {k2_bound_ms:.4f} ms; "
          f"design {json.dumps(k2_design)}")

    # 7. training 2DGS, normal and distortion losses on from the start -------
    opt2d = make_optim(start_stat=0, lambda_normal=0.05, normal_start_iter=0,
                       lambda_dist=0.01, dist_start_iter=0)
    tr2 = _train(cfg2d, opt2d, state, mlps, cams2d[0], bg, cap2, live,
                 "rasterize2d_bwd", ALL, (0, 0, 1, 1, *NO_TOOLS))
    tr2.pop("state")
    # K4 at the main path's shapes: the first timed step's inputs and
    # cotangents (the median's and the distortion's included)
    b_args = tr2.pop("captured")
    f, gid, starts, rec = b_args[0], b_args[1], b_args[2], b_args[7]
    grad_k = raster2d.rasterize2d_bwd(*b_args)
    grad_p = raster2d.rasterize2d_bwd_plain(*b_args)
    torch.cuda.synchronize()
    ok, k4_errs = _compare_k2(grad_k, grad_p)
    walked = _walked_mask(f.shape[0], gid, starts, rec[:, 0])
    zeros_ok = bool((grad_k[~walked] == 0).all())
    d_aux_abs = b_args[4].abs().amax(dim=(0, 2)).tolist()
    print(f"K4 vs plain 1920x1088: {int(walked.sum())} surfels walked "
          f"(exact zeros elsewhere: {zeros_ok}); max |d_aux| rows (log T, "
          f"D, distortion, median) {d_aux_abs}; errors {json.dumps(k4_errs)}")
    _require(ok, "K4 disagrees with its plain version at 1080p")
    _require(zeros_ok, "K4 wrote gradient for surfels no pixel walked")
    _require(min(d_aux_abs[2:]) > 0,
             "no cotangent reached the distortion or the median")
    k4_ms = _time_ms(lambda: raster2d.rasterize2d_bwd(*b_args), 20)
    k4_plain_ms = _time_ms(lambda: raster2d.rasterize2d_bwd_plain(*b_args),
                           1)
    k4_counts = _k34_counts(f, gid, starts, b_args[8], rec)
    k4_inst = int(starts[-1])
    n_pix2 = b_args[8] * b_args[9] * raster2d.P
    # fields, ids and tile starts read once; per pixel d_acc (7 rows),
    # d_aux (4), A, log T, D and the two records: 64 B; the field gradient
    # written once
    k4_bytes = (f.numel() * 4 * 2 + k4_inst * 4 + starts.numel() * 4
                + n_pix2 * 64)
    (k4_bound_ms, k4_bound_by), k4_all_exact_ms = _k34_bound(
        k4_counts, k4_bytes, K4_SFU_WALKED, K4_FP32_WALKED, K4_SFU_CONTRIB,
        K4_FP32_CONTRIB, sfu_rate, fp32_rate)
    k4_design = {**_ptxas(built["K4"].log, "raster2d_bwd_kernel"),
                 "blocks_per_sm": raster2d.occupancy("raster2d_bwd", 0),
                 "bound_share": k4_bound_ms / k4_ms,
                 "bound_ms_all_exact": k4_all_exact_ms,
                 "bound_share_all_exact": k4_all_exact_ms / k4_ms,
                 **k4_counts}
    print(f"K4 1920x1088: {k4_ms:.4f} ms, bound {k4_bound_ms:.4f} ms; "
          f"design {json.dumps(k4_design)}")

    # 8. tools: T1-T3 ---------------------------------------------------------
    from horizongs_tpu_torch.tools.fused_fwd import (
        check_schedules, equal_l_workloads, time_schedules, workload_args)
    from horizongs_tpu_torch.tools.profile_bwd_variants import (
        bwd_scene, time_variants)
    from horizongs_tpu_torch.tools.profile_grid_overhead import (
        graph_times, overhead_table, ring_size)
    torch.set_grad_enabled(False)
    t_tools = time.perf_counter()
    _reset(ALL)
    # T1 against K1, bit for bit: each schedule launched twice
    t1_mism = {"256x256": check_schedules(k1_args_256),
               "1920x1088": check_schedules(k1_args_1080)}
    print(f"T1 vs K1, elements that differ per schedule and launch: "
          f"{json.dumps(t1_mism)}")
    _require(not any(n for d in t1_mism.values() for ns in d.values()
                     for n in ns), "T1 differs from K1")
    ref = raster3d.rasterize_fwd(*k1_args_1080)
    got = raster3d.rasterize_fwd_persistent(*k1_args_1080)
    t1_err = max(float((a - b).abs().max()) for a, b in zip(got[:2], ref[:2]))
    t1_times = {"256x256": time_schedules(k1_args_256),
                "1920x1088": time_schedules(k1_args_1080)}
    t1_sweep = []
    for L, f_np, st_np in equal_l_workloads(60, 34):
        a = workload_args(f_np, st_np, 60, 34, dev)
        mism = check_schedules(a, launches=1)
        _require(not any(n for ns in mism.values() for n in ns),
                 f"T1 differs from K1 on the L={L} workload")
        t1_sweep.append({"L": L, "chunks": 2040 * L, **time_schedules(a)})
        del a
    print(f"T1 ms by schedule: {json.dumps(t1_times)}; equal-L sweep "
          f"{json.dumps(t1_sweep)}")
    # T2: the five variants on the JAX tool's scene and the first training
    # step's K2 inputs; "full" against K2
    scene_args, scene_ri = bwd_scene(device=dev)
    t2 = {"scene": time_variants(scene_args),
          "flagship": time_variants(k2_args_1080)}
    t2_err = {}
    for name, a in (("scene", scene_args), ("flagship", k2_args_1080)):
        ok, t2_err[name] = _compare_k2(
            raster3d.rasterize_bwd_variant("full", *a),
            raster3d.rasterize_bwd(*a))
        _require(ok, f"T2 full disagrees with K2 on the {name} inputs")
    # no_color adds the six geometric gradients only, the others none
    stripped = {}
    for v in raster3d.VARIANTS[1:]:
        out = raster3d.rasterize_bwd_variant(v, *k2_args_1080)
        stripped[v] = float((out[:, 6:] if v == "no_color" else out)
                            .abs().max())
    _require(max(stripped.values()) == 0, f"a stripped variant stored "
             f"gradients it does not form: {stripped}")
    print(f"T2 ({int(scene_ri.inst.n_instances)} instances in the tool's "
          f"scene): {json.dumps(t2)}; full vs K2 {json.dumps(t2_err)}")
    occ = t2["flagship"]["blocks_per_sm"]
    _require(len(set(occ.values())) == 1, f"a T2 variant runs at another "
             f"occupancy than K2: {occ} blocks per SM")
    # T3: device us per block, zero_() beside write
    t3 = overhead_table(dev)
    t3_2040 = next(r for r in t3 if r["blocks"] == 2040)
    _require(t2["flagship"]["ms"]["walk_only"] * 1e3
             > t3_2040["empty"]["device_us"],
             "T2 walk_only is no slower than an empty grid: its work was "
             "compiled away")
    inst = torch.randn((grid_overhead.ROWS, 4096),
                       generator=torch.Generator().manual_seed(6)).to(dev)
    out = torch.empty((2040, grid_overhead.ROWS, grid_overhead.P), device=dev)
    t3_err = {
        "write": float((grid_overhead.write(out) - grid_overhead.write_plain(
            2040, dev)).abs().max()),
        "one_copy": float((grid_overhead.one_copy(inst, out)
                           - grid_overhead.one_copy_plain(inst, 2040))
                          .abs().max())}
    _require(max(t3_err.values()) == 0, f"T3 disagrees with plain: {t3_err}")
    # the plain versions allocate their output: keep the last ones alive,
    # so that each call writes a buffer of a ring, as the kernels do
    held = collections.deque(maxlen=ring_size(2040, dev))
    plain_fns = {"write": lambda: held.append(
                     grid_overhead.write_plain(2040, dev)),
                 "one_copy": lambda: held.append(
                     grid_overhead.one_copy_plain(inst, 2040))}
    t3_plain_ms = {"empty": None}                  # nothing to compute
    for k, fn in plain_fns.items():
        t3_plain_ms[k] = graph_times(fn)["launch_us"] / 1e3
        held.clear()
    print(f"T3 table: {json.dumps(t3)}")
    tool_launches = _counts(TOOLS)
    _require(min(tool_launches) > 0, f"a tool kernel was never launched: "
             f"{tool_launches}")
    tools_s = time.perf_counter() - t_tools

    # 9. densify: one coarse epoch of the trained 3DGS state -----------------
    from horizongs_tpu_torch.convert import (
        train_state_to_device, train_state_to_numpy)
    from horizongs_tpu_torch.train.densify import run_densify
    from horizongs_tpu_torch.train.step import build_train_step
    ts, ct, it = tr.pop("state"), tr.pop("camera"), tr.pop("iteration")
    host = train_state_to_device(ts, "cpu")
    dens = []
    for _ in range(2):        # the first epoch also pays first-use costs
        rep = {}
        ts_d = run_densify(cfg, opt3d, ts, it, stage="coarse", report=rep)
        dens.append(rep)
    rep_h = {}
    ts_h = run_densify(cfg, opt3d, host, it, stage="coarse", report=rep_h)
    want = dict(_flat_leaves(train_state_to_numpy(ts_h)))
    differ = [k for k, v in _flat_leaves(train_state_to_numpy(ts_d))
              if not (v.shape == want[k].shape and (v == want[k]).all())]
    print(f"densify: {ts.n} anchors -> {ts_d.n} (+{rep['added']} "
          f"-{rep['pruned']}), capacity {ts.params.anchor.shape[0]} -> "
          f"{ts_d.params.anchor.shape[0]}; card epochs {json.dumps(dens)}, "
          f"CPU copy {json.dumps(rep_h)}; leaves that differ: {differ}")
    _require(rep["added"] >= 1 and rep["pruned"] >= 1,
             "the densify epoch grew or pruned nothing")
    _require(not differ, f"densify on the card differs from the CPU copy: "
             f"{differ}")
    torch.set_grad_enabled(True)
    cap_d = suggest_instance_cap(count_render_instances(
        cams[0], cfg, ts_d.params.mlps, ts_d.anchor_state()), margin=1.15)
    step_d = build_train_step(cfg, opt3d, H, W, add_prefilter=True,
                              rasterizer="cuda", instance_cap=cap_d)
    _reset(ALL)
    losses_d, dropped_d, step_ms_d = [], [], []
    for _ in range(5):
        it += 1
        t0 = time.perf_counter()
        ts_d, m = step_d(ts_d, ct, it)
        losses_d.append(float(m["loss"]))             # synchronises
        step_ms_d.append((time.perf_counter() - t0) * 1e3)
        dropped_d.append(int(m["n_dropped"]))
    launches_d = _counts(ALL)
    _require(launches_d == (5, 5, 0, 0, *NO_TOOLS),
             f"after densify, kernels launched {launches_d} in 5 steps")
    _require(all(math.isfinite(x) for x in losses_d), f"loss {losses_d}")
    _require(max(dropped_d) == 0, f"instances dropped: {dropped_d}")

    # 10. report -------------------------------------------------------------
    paths = {"serve_3dgs": sv["launches"], "train_3dgs": tr["launches"],
             "serve_2dgs": sv2["launches"], "train_2dgs": tr2["launches"]}

    def launches(i):
        return {p: n[i] for p, n in paths.items()}

    print(json.dumps({
        "slice": "render 1920x1088 flagship LOD (cuda)", "card": card,
        "views": n_views, "view_ms": sv["view_ms"], "view_ms_p50": p50,
        "views_per_s": 1e3 / p50,
        "anchors": state.n, "capacity": state.capacity,
        "decoded_gaussians": state.capacity * cfg.n_offsets,
        "instances_per_view": n_inst, "instance_cap": cap,
        "mean_alpha": alpha_mean}))
    print(json.dumps(_serve_report(sv, card)))
    print(json.dumps(_slice_report("train 1920x1088 flagship LOD (cuda)",
                                   card, tr, cap)))
    p50_2 = _median(sv2["view_ms"])
    print(json.dumps({
        "slice": "render 1920x1088 flagship LOD 2DGS (cuda)", "card": card,
        "views": n_views_2d, "view_ms": sv2["view_ms"],
        "view_ms_p50": p50_2, "views_per_s": 1e3 / p50_2,
        "decoded_surfels": state.capacity * cfg.n_offsets,
        "instances_per_view": n_inst2, "instance_cap": cap2,
        "mean_alpha": alpha_mean2, **_serve_report(sv2, card)}))
    print(json.dumps(_slice_report(
        "train 1920x1088 flagship LOD 2DGS, normal + distortion (cuda)",
        card, tr2, cap2)))
    print(json.dumps({
        "slice": "densify 1920x1088 flagship LOD, one coarse epoch (cuda)",
        "card": card, "anchors_before": ts.n, "anchors_after": ts_d.n,
        "added": rep["added"], "pruned": rep["pruned"],
        "capacity_before": ts.params.anchor.shape[0],
        "capacity_after": ts_d.params.anchor.shape[0],
        "epoch_ms_by_phase": dens, "cpu_copy_epoch_ms_by_phase": rep_h,
        "instance_cap_after": cap_d, "losses_after": losses_d,
        "step_ms_after": step_ms_d,
        "launches_after": dict(zip(("K1", "K2", "K3", "K4"),
                                   launches_d[:4]))}))
    print(json.dumps({"slice": "tools T1-T3 (cuda)", "card": card,
                      "seconds": tools_s,
                      "T1_ms": t1_times, "T1_equal_l_sweep": t1_sweep,
                      "T2_ms": t2, "T3_table": t3}))

    def tool_paths(j):
        return {**{p: n[4 + j] for p, n in paths.items()},
                "tools": tool_launches[j]}

    f2, n_pix2_3d = k2_args_1080[0], k2_args_1080[7] * k2_args_1080[8] * \
        raster3d.P
    t2_entries = []
    for j, v in enumerate(raster3d.VARIANTS):
        sfu_c, fp32_c = T2_CONTRIB_OPS[v]
        # fields, ids and tile starts read once and 32 B per pixel; only
        # the variants that add gradients write the field gradient
        t2_bytes = (f2.numel() * 4 * (2 if v in ("full", "no_color") else 1)
                    + int(k2_args_1080[2][-1]) * 4
                    + k2_args_1080[2].numel() * 4 + n_pix2_3d * 32)
        (b_ms, b_by), b_all_exact_ms = _k12_bound(
            k2_counts, t2_bytes, (sfu_c, fp32_c),
            (K2_SFU_WALKED, K2_FP32_WALKED), (sfu_c, fp32_c), sfu_rate,
            fp32_rate)
        t2_entries.append({
            "name": f"raster3d_bwd {v} (T2)", "route": "cuda",
            "source": "horizongs_tpu_torch/csrc/raster3d_bwd.cu"
                      + ("" if v == "full" else f" -DK2_VARIANT={j}"),
            "replaces": "tools/profile_bwd_variants.py:187",
            "launches": tool_launches[1 + j],
            "launches_by_path": tool_paths(1 + j),
            "max_abs_err": (t2_err["flagship"]["max_abs_err"] if v == "full"
                            else stripped[v]),
            "tolerance": {"full": f"per field {K2_TOL} x max |grad| "
                                  "against K2",
                          "no_color": "colour and depth gradients all "
                                      "zeros"}.get(v, "stores nothing: "
                                                      "output all zeros"),
            "ms": t2["flagship"]["ms"][v],
            "minus_full_ms": t2["flagship"]["minus_full_ms"][v],
            "scene_ms": t2["scene"]["ms"][v],
            "blocks_per_sm": t2["flagship"]["blocks_per_sm"][v],
            "pad_bytes": t2["flagship"]["pad_bytes"][v],
            # a stripped variant computes no function: it has no plain
            # version
            "plain_ms": k2_plain_ms if v == "full" else None,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_all_exact": b_all_exact_ms, "library_ms": None,
            "card": card})
    t3_bytes = {"empty": 0,
                "write": 2040 * grid_overhead.ROWS * grid_overhead.P * 4,
                "one_copy": (2040 * grid_overhead.ROWS * grid_overhead.P * 4
                             + grid_overhead.ROWS * grid_overhead.COPY_COLS
                             * 4)}
    t3_entries = [{
        "name": f"grid_overhead {k} (T3)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/grid_overhead.cu",
        "replaces": "tools/profile_grid_overhead.py:40",
        "launches": tool_launches[1 + len(raster3d.VARIANTS) + j],
        "launches_by_path": tool_paths(1 + len(raster3d.VARIANTS) + j),
        "max_abs_err": t3_err.get(k, 0.0),
        "tolerance": "exactly equal" if k != "empty" else "no output",
        # launch to launch from a CUDA graph: the kernel's own time ends
        # before L2 has written its last bytes back
        "ms": t3_2040[k]["launch_us"] / 1e3,
        "kernel_ms": t3_2040[k]["device_us"] / 1e3,
        "device_us_per_block": t3_2040[k]["device_us_per_block"],
        "host_us_per_launch": t3_2040[k]["host_us_per_launch"],
        "blocks": 2040, "plain_ms": t3_plain_ms[k],
        "bound_ms": t3_bytes[k] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": (t3_2040["zero_"]["launch_us"] / 1e3
                       if k == "write" else None),
        "card": card} for j, k in enumerate(("empty", "write", "one_copy"))]
    print(json.dumps({"kernels": [{
        "name": "raster3d_fwd (K1)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/raster3d_fwd.cu",
        "replaces": "horizongs_tpu/ops/pallas/raster3d.py:189",
        "launches": sum(launches(0).values()),
        "launches_by_path": launches(0),
        "max_abs_err": max(k1_errs["acc_rgb_alpha"], k1_errs["acc_depth"],
                           k1_errs["T"]),
        "errors": k1_errs,
        "tolerance": "acc atol 1e-4 (depth + rtol 2e-4); exp(logT) atol "
                     "1e-4; i_fin within 1; n_contrib equal or at the stop",
        "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by, "library_ms": None, **k1_design,
        "instances": k1_inst,
        "sm_clock_mhz": sm_clock_hz / 1e6, "card": card}, {
        "name": "raster3d_bwd (K2)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/raster3d_bwd.cu",
        "replaces": "horizongs_tpu/ops/pallas/raster3d.py:359",
        "launches": sum(launches(1).values()),
        "launches_by_path": launches(1),
        "max_abs_err": k2_errs["max_abs_err"], "errors": k2_errs,
        "tolerance": f"per field {K2_TOL} x max |grad| of the field; "
                     "exact zeros for gaussians no pixel walked",
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
        "bound_by": k2_bound_by, "library_ms": None, **k2_design,
        "instances": k2_inst, "sm_clock_mhz": sm_clock_hz / 1e6,
        "card": card}, {
        "name": "raster2d_fwd (K3)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/raster2d_fwd.cu",
        "replaces": "horizongs_tpu/ops/pallas/raster2d.py:147",
        "launches": sum(launches(2).values()),
        "launches_by_path": launches(2),
        "max_abs_err": max(k3_errs["acc"], k3_errs["D"],
                           k3_errs["distortion"], k3_errs["T"]),
        "errors": k3_errs,
        "tolerance": "acc atol 1e-4; D + rtol 2e-4; distortion + 2e-4 x "
                     "(|dist| + D); exp(logT) atol 1e-4; median equal on "
                     "the same surfel; records equal or at a boundary",
        "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
        "bound_by": k3_bound_by, "library_ms": None, **k3_design,
        "instances": k3_inst, "sm_clock_mhz": sm_clock_hz / 1e6,
        "card": card}, {
        "name": "raster2d_bwd (K4)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/raster2d_bwd.cu",
        "replaces": "horizongs_tpu/ops/pallas/raster2d.py:285",
        "launches": sum(launches(3).values()),
        "launches_by_path": launches(3),
        "max_abs_err": k4_errs["max_abs_err"], "errors": k4_errs,
        "tolerance": f"per field {K2_TOL} x max |grad| of the field; "
                     "exact zeros for surfels no pixel walked",
        "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound_ms,
        "bound_by": k4_bound_by, "library_ms": None, **k4_design,
        "instances": k4_inst, "sm_clock_mhz": sm_clock_hz / 1e6,
        "card": card}, {
        "name": "raster3d_fwd_persistent (T1)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/raster3d_fwd_persistent.cu",
        "replaces": "tools/experiment_fused_fwd.py:162",
        "launches": tool_launches[0], "launches_by_path": tool_paths(0),
        "max_abs_err": t1_err,
        "tolerance": "bit for bit K1's acc, log T, i_fin and n_contrib",
        "ms": t1_times["1920x1088"]["dynamic"],
        "ms_static": t1_times["1920x1088"]["static"],
        "k1_ms_same_inputs": t1_times["1920x1088"]["k1"],
        "grid": t1_times["1920x1088"]["grid"],
        "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by, "bound_ms_all_exact": k1_all_exact_ms,
        "library_ms": None, "card": card},
        *t2_entries, *t3_entries]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
