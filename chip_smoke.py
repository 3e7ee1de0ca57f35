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
               `zero_()` and `copy_`, launched back to back from a CUDA
               graph
               (`tools/profile_grid_overhead.py`). Serving and training
               (phases 4-7) must have launched none of them
 8b. P1        the 3DGS projection (`csrc/project3d.cu`): counted with
               K1-K4 in phases 4-7 (the forward once a 3DGS request, the
               forward and backward once a 3DGS step, neither on the 2DGS
               paths); then over 10,035,200 random rows the forward bit
               for bit the plain path's fields, radii and cull radii, and
               the backward's error against the plain path in float64 at
               most twice the plain float32 path's, leaf by leaf; then
               both timed beside their bytes bound and the plain path
               (`tools/profile_project.py`), with ptxas's registers and
               spills from the build phase; its line is `P1 10035200 rows`
               and its two entries are in the kernels line
  9. densify   one coarse `run_densify` epoch of the trained 3DGS state on
               the card (the statistics gates opened for 22 steps): at
               least one anchor grown and one pruned, equal to the same
               epoch on a CPU copy (n, levels, tables, moments,
               statistics), timed by phase; then 5 steps at the new
               capacity with a recalibrated cap: K1 and K2 once per step,
               K3, K4 and the tools never, nothing dropped, loss finite
 10. train CLI `cli.make_synthetic` writes the flagship512 dataset (24
               train and 4 test views at 512x512 from 12,000 gaussians,
               seed 0); `cli.train.main` on configs/synthetic/flagship512.yaml
               trains 600 coarse iterations (densify epochs on the
               config's schedule, a checkpoint) and evaluates the test set;
               the saved PLY and MLPs read back bit for bit; 20 more
               iterations of that trainer under the profiler; a resume from
               the checkpoint (its first loss within the last 20 before
               it); a fine stage of 250 iterations from the coarse output
               (MLPs frozen bit for bit, the coarse rows equal to the base
               copies after every epoch); 60 iterations as 2DGS. Each run
               sets the counts to 0 just before it and reads them after:
               K1 and K2 once per step (K3 and K4 for 2DGS) plus K1 once
               per evaluation render, no tool; losses finite and lower at
               the end, at least two densify epochs, every overflow
               recalibrated, nothing dropped in the evaluation; timed
               (iterations/s, host time outside the step, densify epochs,
               evaluation per view, test PSNR and SSIM)
 11. serve CLI on phase 10's model directories, before they go, each
               run with the counts set to 0 just before it and read just
               after: `cli.render` renders the coarse model's 24 train and
               4 test views (K1 once per view plus one per recalibration,
               every image finite, nothing dropped) and a 30-frame
               fly-through; `cli.metrics` scores the written PNGs (PSNR
               within 0.1 dB of phase 10's, LPIPS null without weights) and
               LPIPS from `init_random_weights(0)` on the card equals the
               CPU's (rtol 1e-4); `serve_model` on 127.0.0.1:0 answers 8
               requests at 1920x1088 made from the dataset's cameras, a
               keep-alive and one request at scaling_modifier 0.5, each
               frame byte for byte the uint8 quantisation of the in-process
               `render()` of its camera (K1 once per image request plus
               recalibrations); the flagship at SH1, view_dim 0 baked on the
               card (equal to a CPU copy's bake within 1e-5), written,
               read and rendered at 4 orbit views at 1920x1088 through K1
               (within 2e-3 of the neural render); `cli.export_mesh` of the
               2DGS model at 128^3 (K3 once per train view, a non-empty
               finite mesh, the card's float64 TSDF equal to the CPU
               copy's within 1e-9); timed
 12. chunks    on phase 10's dataset, before it goes, in a temporary
               working directory: `cli.partition` of
               configs/synthetic/chunks512.yaml (2x1 chunks, LOD estimated;
               no kernel); `train_chunks` coarse (300 iterations) then fine
               (150) for each chunk in this process through the generated
               configs, unedited, each job with the counts set to 0 just
               before it and read after: K1 and K2 once per iteration plus
               K1 once per evaluation render, nothing else, losses finite,
               overflows recalibrated, nothing dropped, at least 2 densify
               epochs coarse and 1 fine, the fine stage's MLPs the coarse
               model's bit for bit and its coarse rows the base copies
               after every roll-back, an explicit PLY per job; `cli.merge`
               with the evaluation: K1 once per test view (plus
               recalibrations), the merged rows recounted on the card from
               the chunks' PLYs, the merged arrays bit for bit the cropped
               rows in chunk order, every merged gaussian in the true
               bounds, the chunks' obj_info, PSNR and SSIM finite; a
               256x256 view of the merged model through K1 against the
               dense oracle (2e-4); timed (partition ms, per job scene
               load, it/s, iteration p50/p90, densify epochs; merge pass 1
               and pass 2 ms)
 13. mesh      `parallel/step.py` on `torch.distributed`, each run with
               the counts set to 0 just before it and read just after
               (ranks write theirs to a file, summed here). The steps run
               `tools/mesh_check` through `torch.distributed.run` on the
               flagship model of phase 6 at 1920x1088: a 1x1 mesh with
               NCCL (one rank), then two gloo ranks on this one card: the
               1x2 band step of 3DGS (K1/K2) and of 2DGS (K3/K4, the
               normal loss held, the distortion on in the timed steps),
               the 3DGS replicated fallback, and 2x1 data-parallel steps
               of two views and of one view repeated at weight 1/2. Each
               case's gradients and losses are held to the single-device
               `TrainStep` (the views' weighted mean; 2e-4 x max, rtol
               1e-5), each kernel launched once a step a rank, nothing
               dropped; 2 + N timed steps a case (p50, the exchange's
               bytes and ms with host staging, the collectives' ms, a
               profiled step on every rank, the band matrix's column
               sums); the forward and backward kernels of one step of the
               1x1, 1x2 (both models) and 2x1 cases against their plain
               versions on the arguments that step gave them (a band's
               rows; K3/K4 with its first row). Then, inside phase 10, on
               its dataset: `cli.train --mesh 1x2` through
               `torch.distributed.run` (`--mesh-cli`: 300 coarse
               iterations, a densify epoch, a sharded checkpoint, the
               test-set evaluation) and a resume from that checkpoint at
               `--mesh 1x1` (NCCL) for 20: K1 and K2 once an iteration a
               rank plus K1 once an evaluation render, every overflow
               recalibrated, PSNR finite
 14. rest      a. inside phase 10, on its dataset: the native image and
               COLMAP loader (`horizongs_tpu_torch/native.py`) built,
               timed, or its reason printed and the phase goes on; when
               built, the 28 views through `camera_list` at resolution 1
               within an ulp of PIL and at resolution 2 bit for bit
               `load_image_rgba` and `ImagePool.load_many`, and a
               1M-point points3D.bin parsed natively equal to the Python
               walk; each loader the machine has (PIL always) timed:
               `camera_list` for the 28 views, ms per image, the parse
               (no kernel).
               b. phase 13's 1x2 band cases (3DGS, 2DGS), whose
               `tools/mesh_check` calibrates instance_cap and band_cap as
               the trainer does: the capacities, the MB exchanged a step
               and p50 a rank. c. `tools/profile_band_overhead` at 1x1
               (one NCCL rank): the band step against `TrainStep` by
               kernel name, the rows summing to the busy difference
               within 5%, K1 and K2 once a step in each. d.
               `tools/convergence_check` on quickstart for 400 iterations,
               single device then `--mesh 1x2` (two gloo ranks): PSNRs
               finite, the same densify epochs, K1 and K2 once an
               iteration on every rank; the PSNR gap and anchor counts;
               K1 and K2 held to their plain versions on the last
               iteration's arguments of each run (each rank's band).
               e. `tools/bench_densify` at 1M anchors x 10 offsets: the
               table's build, the JAX tool's densify epoch and a growth
               epoch that adds rows, the npz and the 1x1 sharded
               checkpoint saved and loaded bit for bit, timed. The
               counts are set to 0 before b-e and read after, each
               launched process's from its start to its end (the tools'
               records), and no other kernel runs
 15. scaling   `tools/bench_scaling` through its command line, each
               mode with the counts set to 0 just before it and read just
               after (the sweep's ranks count their own and write them to
               its file): a. the sweep `--devices 1,2` at 512x512 (one
               NCCL rank; two gloo ranks on this card: the 1x2 band step
               and its 2x1 pure-DP control; `1,2,4` on NCCL when the
               machine shows four cards); b. `--tpu_overhead` (the band
               step at 1x1 against `TrainStep` at 1920x1088); c.
               `--band_times` at 1920x1088 on 6 street views; d.
               `--project 4` and `--project 8` on b's and c's records; e.
               `--imbalance` at 512x512. K1 and K2 once a step a rank in
               a-c and no kernel in d-e, nothing dropped after the tool's
               re-runs at wider margins, the count guard held; then K1 and
               K2 against their plain versions on the arguments of one
               cropped step of c (the tallest n_model=8 band of view 0, a
               shifted principal point); timed
 16. report    per-view and per-step timings, the layer breakdowns, the
               densify epoch, the train CLI, the serve CLI, the chunks,
               the mesh, the rest, the scaling tool, the tools' tables,
               the kernels line, and last the device line

Prints nothing after a failure and exits non-zero without a card or
without the package beside it. `--mesh-cli` is the worker mode phase 13
starts itself.
"""
import collections
import contextlib
import dataclasses
import json
import math
import os
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


def _compare_k3(kern, plain, atol, k_args, row0=0):
    """Max errors of K3 against its plain version, and the tolerance check:
    the acc rows (rgb, normal, alpha) within `atol`; D within `atol` + rtol
    2e-4; the distortion within `atol` + 2e-4 x (|distortion| + D) (its
    terms are of the size of D, summed in other orders); exp(log T) atol
    1e-4; the median depth equal where both name the same surfel; n_contrib
    and the median's position equal or at a boundary that rounding moves
    (`raster2d.records_off_the_boundary`). `row0`: the first pixel row the
    runs composited (a band of a view)."""
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
                                   aux_p[:, 0], row0)
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
             f"kernels launched {launches} times for {len(cams)} requests "
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
             f"kernels launched {launches} times in {n_steps} steps of "
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


class _Wrapped:
    """Swap `module.name` for `make(original)` inside a with-block."""

    def __init__(self, module, name, make):
        self.module, self.name, self.make = module, name, make

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self.make(self.orig))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _checked_densify(orig, base_of, epochs, dev):
    """`run_densify` that, in the fine stage, records after every epoch
    whether the coarse-level rows equal the base copies `base_of()` (rolled
    back before the epoch), their gaussian scales under the epoch's clamp,
    into `epochs`."""
    import torch

    def run_densify(cfg, op, st, it, **kw):
        out = orig(cfg, op, st, it, **kw)
        if kw.get("stage") == "fine":
            base = base_of()
            rows = torch.nonzero(out.level[:out.n]
                                 < cfg.aerial_levels).squeeze(1)
            a = out.anchor_state()
            ok = rows.numel() == base["anchor"].shape[0]
            for k in ("anchor", "offset", "feat", "rotation", "scaling_log"):
                want = torch.from_numpy(base[k]).to(dev)
                if k == "scaling_log":
                    want[:, 3:] = want[:, 3:].clamp_max(0.05)
                ok = ok and torch.equal(getattr(a, k)[rows].detach(), want)
            epochs.append({"iteration": it, "coarse_rows": rows.numel(),
                           "equal_to_base": ok})
        return out
    return run_densify


def _train_cli(root, kernels, dev, then, n_train=24, n_test=4, size=512,
               n_gauss=12000, coarse_its=600, window=20, resume_its=20,
               fine_its=250, its_2d=60):
    """Phase 10: the port's train CLI on the flagship512 config, in a
    temporary directory: the dataset (`cli.make_synthetic`), a coarse run
    with a checkpoint and the test-set evaluation, the saved files read
    back, a profiled window of `window` more iterations of the coarse
    trainer, a resume from the checkpoint, a fine stage from the coarse
    output and a 2DGS run. `kernels` are K1, K2, K3, K4 and then the tools;
    each CLI run sets every count to 0 just before it and reads them just
    after: K1 and K2 once per step of a 3DGS run (K3 and K4 for 2DGS) plus
    K1 once per evaluation render (re-renders after a counted overflow
    included), nothing else. Then `then(coarse_dir, surfel_dir, report)`
    runs on the model directories and the dataset (phases 11 and 12)
    before the directory goes.
    Returns (the phase's report, `then`'s result)."""
    import shutil
    import tempfile

    import torch
    import yaml
    from horizongs_tpu_torch.cli.make_synthetic import main as make_synthetic
    from horizongs_tpu_torch.cli.train import main as train_main
    from horizongs_tpu_torch.data import scene as scene_mod
    from horizongs_tpu_torch.io.checkpoints import (
        load_anchor_ply, load_mlp_checkpoints)
    from horizongs_tpu_torch.tools.timing import device_profile
    from horizongs_tpu_torch.train import evaluate as evaluate_mod
    from horizongs_tpu_torch.train import trainer as trainer_mod
    n_k = len(kernels)
    zero = (0,) * n_k
    runs, evals, renders, scenes, fine_epochs = [], [], [], [], []

    def wrap_train(orig):
        def train(self, *args, **kw):
            before = _counts(kernels)
            t0 = time.perf_counter()
            hist = orig(self, *args, **kw)
            torch.cuda.synchronize()
            runs.append({"trainer": self, "hist": hist,
                         "seconds": time.perf_counter() - t0,
                         "launches": tuple(a - b for a, b in zip(
                             _counts(kernels), before))})
            return hist
        return train

    def wrap_render_set(orig):
        def render_set(*args, **kw):
            out = orig(*args, **kw)
            evals.append(out[3])
            return out
        return render_set

    def wrap_render(orig):
        def render(*args, **kw):
            pkg = orig(*args, **kw)
            renders.append(int(pkg["n_dropped"]))
            return pkg
        return render

    class TimedScene(scene_mod.Scene):
        def __init__(self, *args, **kw):
            t0 = time.perf_counter()
            super().__init__(*args, **kw)
            scenes.append({"scene": self,
                           "seconds": time.perf_counter() - t0,
                           "camera_bytes": self.camera_bytes()})

    def wrap_densify(orig):
        return _checked_densify(orig, lambda: scenes[-1]["scene"].base,
                                fine_epochs, dev)

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        data = str(work / "data")
        t0 = time.perf_counter()
        make_synthetic([data, "--n_train", str(n_train), "--n_test",
                        str(n_test), "--width", str(size), "--height",
                        str(size), "--n_gauss", str(n_gauss), "--seed", "0"])
        torch.cuda.synchronize()
        dataset_s = time.perf_counter() - t0
        with open(root / "configs" / "synthetic" / "flagship512.yaml") as f:
            base_cfg = yaml.safe_load(f)

        def config(name, **kwargs):
            c = json.loads(json.dumps(base_cfg))
            c["model_params"]["model_config"]["kwargs"].update(
                kwargs.pop("model_kwargs", {}))
            c["model_params"].update(kwargs)
            path = work / f"{name}.yaml"
            with open(path, "w") as f:
                yaml.safe_dump(c, f)
            return str(path)

        phase_launches = [0] * n_k

        def cli(name, cfg_path, *argv):
            """One CLI run with every count at 0 just before it: (run,
            launches, evaluation render calls, seconds)."""
            n_runs, n_renders = len(runs), len(renders)
            _reset(kernels)
            t0 = time.perf_counter()
            rc = train_main(["--config", cfg_path, "--source_path", data,
                             "--model_path", str(work / name),
                             "--disable_tb", *argv])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            total = _counts(kernels)
            _require(rc == 0, f"train CLI {name} returned {rc}")
            _require(len(runs) == n_runs + 1,
                     f"train CLI {name}: {len(runs) - n_runs} train runs")
            for i, n in enumerate(total):
                phase_launches[i] += n
            return runs[-1], total, renders[n_renders:], seconds

        def check_launches(name, run, total, eval_calls, per_step):
            n = len(run["hist"])
            want = tuple(n * e for e in per_step) + zero[len(per_step):]
            _require(run["launches"] == want,
                     f"{name}: kernels launched {run['launches']} in {n} "
                     f"iterations, expected {want}")
            ev = tuple(t - r for t, r in zip(total, run["launches"]))
            _require(ev == (len(eval_calls),) + zero[1:],
                     f"{name}: evaluation launched {ev} for "
                     f"{len(eval_calls)} renders")
            return ev

        def losses_ok(name, hist):
            _require(all(math.isfinite(x) for x in hist),
                     f"{name}: a loss is not finite")

        with _Wrapped(trainer_mod.Trainer, "train", wrap_train), \
                _Wrapped(trainer_mod, "run_densify", wrap_densify), \
                _Wrapped(evaluate_mod, "render_set", wrap_render_set), \
                _Wrapped(evaluate_mod, "render", wrap_render), \
                _Wrapped(scene_mod, "Scene", lambda orig: TimedScene):
            # coarse
            cfg3d = config("coarse")
            run, total, ev_calls, coarse_s = cli(
                "coarse", cfg3d, "--iterations", str(coarse_its),
                "--checkpoint_iterations", str(coarse_its))
            tr, hist = run["trainer"], run["hist"]
            ev_coarse = check_launches("coarse", run, total, ev_calls,
                                       (1, 1))
            losses_ok("coarse", hist)
            _require(sum(hist[-50:]) < sum(hist[:50]),
                     "coarse: loss did not fall over the run")
            dens = tr.records["densify"]
            _require(len(dens) >= 2 and any(d["added"] > 0 for d in dens),
                     f"coarse: densify epochs {dens}")
            overflows = tr.records["overflows"]
            _require(all(o["widened"] or o["margin"] * 1.5 >
                         tr.MARGIN_CEIL for o in overflows),
                     f"an overflow was not recalibrated: {overflows}")
            _require(ev_calls.count(0) == n_test,
                     f"evaluation renders' dropped counts {ev_calls}")
            out = work / "coarse"
            it_dir = out / "point_cloud" / f"iteration_{coarse_its}"
            for p in (it_dir / "point_cloud.ply", it_dir / "mlps.npz",
                      out / f"chkpnt{coarse_its}.npz",
                      out / "results_test.json"):
                _require(p.is_file(), f"coarse: {p.name} not written")
            with open(out / "results_test.json") as f:
                res = json.load(f)[f"ours_{coarse_its}"]["all"]
            _require(math.isfinite(res["PSNR"]), f"test PSNR {res}")

            # read-back: the saved files equal the trained state's rows
            st = tr.state.anchor_state()
            got, _ = load_anchor_ply(str(it_dir / "point_cloud.ply"),
                                     tr.cfg, device=dev)
            differ = [k for k in ("anchor", "offset", "feat", "scaling_log",
                                  "rotation", "level", "extra_level")
                      if not torch.equal(getattr(got, k)[:st.n],
                                         getattr(st, k)[:st.n].detach())]
            mlps600 = load_mlp_checkpoints(str(it_dir), device=dev)
            differ += [f"mlps.{n}" for (n, a), b in zip(
                mlps600.named_parameters(),
                tr.state.params.mlps.parameters()) if not torch.equal(a, b)]
            _require(got.n == st.n and not differ,
                     f"read-back differs from the trained state: {differ}")

            # a profiled window of the coarse trainer, its steps built
            n0 = len(runs)
            _reset(kernels)
            prof = device_profile(lambda: tr.train(
                iterations=coarse_its + window, first_iter=coarse_its + 1))
            win = runs[n0]
            _require(win["launches"] == (window, window) + zero[2:],
                     f"window launched {win['launches']}")
            for i, n in enumerate(win["launches"]):
                phase_launches[i] += n

            # resume from the checkpoint
            run_r, total_r, _, resume_s = cli(
                "resume", cfg3d, "--start_checkpoint",
                str(out / f"chkpnt{coarse_its}.npz"), "--iterations",
                str(coarse_its + resume_its), "--skip_eval")
            check_launches("resume", run_r, total_r, [], (1, 1))
            losses_ok("resume", run_r["hist"])
            last = hist[-20:]
            _require(min(last) <= run_r["hist"][0] <= max(last),
                     f"first resumed loss {run_r['hist'][0]} outside the "
                     f"last 20 before the checkpoint {last}")

            # fine stage from the coarse output
            run_f, total_f, ev_f, fine_s = cli(
                "fine", config("fine", pretrained_checkpoint=str(it_dir)),
                "--iterations", str(fine_its))
            ev_fine = check_launches("fine", run_f, total_f, ev_f, (1, 1))
            losses_ok("fine", run_f["hist"])
            tf = run_f["trainer"]
            _require(tf.scene.stage == "fine" and tf.scene.frozen_mlps,
                     "fine: not a fine stage")
            _require(all(torch.equal(a, b) for a, b in zip(
                tf.state.params.mlps.parameters(), mlps600.parameters())),
                "fine: the frozen MLPs moved")
            _require(fine_epochs and all(e["equal_to_base"]
                                         for e in fine_epochs),
                     f"fine: coarse rows after the epochs {fine_epochs}")
            with open(work / "fine" / "results_test.json") as f:
                res_f = json.load(f)[f"ours_{fine_its}"]["all"]
            _require(math.isfinite(res_f["PSNR"]), f"fine PSNR {res_f}")

            # 2DGS
            run_2, total_2, _, s_2d = cli(
                "surfel", config("surfel", model_kwargs={"gs_attr": "2D"}),
                "--iterations", str(its_2d), "--skip_eval")
            check_launches("2DGS", run_2, total_2, [], (0, 0, 1, 1))
            losses_ok("2DGS", run_2["hist"])
        after = then(out, work / "surfel",
                     {"coarse_its": coarse_its, "its_2d": its_2d,
                      "test_psnr": res["PSNR"],
                      "fine_test_psnr": res_f["PSNR"], "n_train": n_train,
                      "n_test": n_test, "size": size, "data": data})
    finally:
        shutil.rmtree(work, ignore_errors=True)

    it_ms, step_ms = tr.records["iteration_ms"], tr.records["step_ms"]
    outside = [a - b for a, b in zip(it_ms, step_ms)]
    busy = prof["busy_ms"] / window
    return {
        "dataset_s": dataset_s, "scene_load_s": scenes[0]["seconds"],
        "camera_bytes_on_card": scenes[0]["camera_bytes"],
        "coarse": {
            "iterations": coarse_its, "cli_s": coarse_s,
            "train_s": run["seconds"],
            "iterations_per_s": coarse_its / run["seconds"],
            "iteration_ms_p50": _median(it_ms),
            "iteration_ms_p90": _pct(it_ms, 0.9),
            "step_ms_p50": _median(step_ms),
            "host_ms_outside_step_p50": _median(outside),
            "host_ms_outside_step_mean": sum(outside) / len(outside),
            "loss_first50_mean": sum(hist[:50]) / 50,
            "loss_last50_mean": sum(hist[-50:]) / 50,
            "densify_epochs": dens, "overflows": overflows,
            "launches_train": run["launches"][:4],
            "launches_eval": ev_coarse[:4],
            "eval_renders": len(ev_calls),
            "eval_ms_per_view": [t * 1e3 for t in evals[0]],
            "test_psnr": res["PSNR"], "test_ssim": res["SSIM"],
            "anchors_final": st.n, "capacity_final": got.capacity},
        "window": {"iterations": window,
                   "launches": win["launches"][:4],
                   "wall_ms_per_iteration": prof["wall_ms"] / window,
                   "device_busy_ms_per_iteration": busy,
                   "device_idle_share": 1 - prof["busy_ms"]
                   / prof["wall_ms"],
                   "top_kernels_ms": sorted(
                       prof["by_name"].items(), key=lambda kv: -kv[1])[:8]},
        "resume": {"iterations": resume_its, "cli_s": resume_s,
                   "first_loss": run_r["hist"][0],
                   "last20_before": [min(last), max(last)],
                   "launches": run_r["launches"][:4]},
        "fine": {"iterations": fine_its, "cli_s": fine_s,
                 "epochs": fine_epochs,
                 "densify": tf.records["densify"],
                 "launches_train": run_f["launches"][:4],
                 "launches_eval": ev_fine[:4],
                 "test_psnr": res_f["PSNR"], "test_ssim": res_f["SSIM"]},
        "surfel_2dgs": {"iterations": its_2d, "cli_s": s_2d,
                        "launches": run_2["launches"][:4],
                        "loss_first": run_2["hist"][0],
                        "loss_last": run_2["hist"][-1]},
        "launches": tuple(phase_launches)}, after


def _wire_1080(cam, mod=1.0, W=1920, H=1088):
    """A dataset camera as a viewer request at W x H: its pose, its
    horizontal field of view, square pixels."""
    import numpy as np
    from horizongs_tpu_torch.viewer.server import request_message
    fx = float(cam.K[0, 0]) * W / cam.width
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
    return request_message(cam.viewmat.cpu().numpy(), K, W, H,
                           scaling_modifier=mod)


def _serve_cli(coarse, surfel, info, kernels, dev):
    """Phase 11: the serving and export entry points on the model
    directories phase 10 wrote (the 600-iteration coarse model and the
    60-iteration 2DGS one), each run with every count set to 0 just before
    it and read just after; then the explicit model at the flagship's
    widths. Returns the phase's report and its launches."""
    import copy
    import glob
    import socket
    import threading

    import numpy as np
    import torch
    from horizongs_tpu_torch.cli import export_mesh as export_mod
    from horizongs_tpu_torch.cli.common import load_config
    from horizongs_tpu_torch.cli.metrics import main as metrics_main
    from horizongs_tpu_torch.cli.metrics import read_images
    from horizongs_tpu_torch.cli.render import main as render_main
    from horizongs_tpu_torch.data.scene import Scene
    from horizongs_tpu_torch.data.synthetic import (
        orbit_cameras, random_gaussians)
    from horizongs_tpu_torch.io.checkpoints import (
        load_explicit_ply, save_explicit_ply)
    from horizongs_tpu_torch.models import explicit as explicit_mod
    from horizongs_tpu_torch.models.anchors import (
        init_anchor_state_from_points)
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.mlp import init_mlps
    from horizongs_tpu_torch.ops.raster_cuda import suggest_instance_cap
    from horizongs_tpu_torch.render import count_render_instances, render
    from horizongs_tpu_torch.tools.timing import best_ms, device_profile
    from horizongs_tpu_torch.train import evaluate as evaluate_mod
    from horizongs_tpu_torch.train import lpips as lpips_mod
    from horizongs_tpu_torch.utils.meshing import read_mesh_ply
    from horizongs_tpu_torch.viewer import server as viewer_mod
    n_k = len(kernels)

    def launches(k1=0, k3=0):
        return (k1, 0, k3) + (0,) * (n_k - 3)
    phase = [0] * n_k
    rep = {}

    def counted(name, fn, want):
        """fn() with every count at 0 just before and read just after;
        `want(result)` is the launches it must have made."""
        _reset(kernels)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = _counts(kernels)
        exp = want(out)
        _require(got == exp, f"{name}: kernels launched {got}, expected "
                 f"{exp}")
        for i, n in enumerate(got):
            phase[i] += n
        return out, seconds

    # 1. render CLI: the sets, then a 30-frame fly-through --------------------
    draws, sets = [], []

    def wrap_draw(orig):
        def draw(*args, **kw):
            pkg = orig(*args, **kw)
            draws.append(int(pkg["n_dropped"]))
            return pkg
        return draw

    def wrap_set(orig):
        def render_set(*args, **kw):
            out = orig(*args, **kw)
            sets.append(out)
            return out
        return render_set

    def one_k1_per_render(_):
        return launches(k1=len(draws))

    with _Wrapped(evaluate_mod, "render", wrap_draw), \
            _Wrapped(evaluate_mod, "render_set", wrap_set):
        # K1 once per render: once per view, and once more for each
        # re-render after a counted overflow and a recalibration
        _, sets_s = counted("render CLI", lambda: render_main(
            ["-m", str(coarse)]), one_k1_per_render)
        views = info["n_train"] + info["n_test"]
        n_draw = len(draws)
        _require(draws.count(0) == views,
                 f"render CLI: {n_draw} renders for {views} views, dropped "
                 f"counts {draws}")
        size = (info["size"], info["size"], 3)
        for r in [r for out in sets for r in out[0]]:
            _require(r.shape == size and bool(np.isfinite(r).all()),
                     "render CLI: an image is not finite")
        set_ms = [t * 1e3 for out in sets for t in out[3]]
        draws.clear()
        _, path_s = counted("fly-through", lambda: render_main(
            ["-m", str(coarse), "--skip_train", "--skip_test",
             "--path_video", "--path_frames", "30"]), one_k1_per_render)
        frames = glob.glob(str(coarse / "path_frames" / "*.png"))
        _require(len(frames) == 30 and draws.count(0) == 30,
                 f"fly-through: {len(frames)} frames, dropped {draws}")
    rep["render_cli"] = {
        "views": views, "renders": n_draw, "seconds": sets_s,
        "view_ms": set_ms, "view_ms_p50": _median(set_ms),
        "path_frames": 30, "path_renders": len(draws), "path_s": path_s}

    # 2. metrics: PSNR against phase 10's, LPIPS on the card against the CPU
    it = info["coarse_its"]
    _, metrics_s = counted("metrics", lambda: metrics_main(
        ["-m", str(coarse)]), lambda _: launches())
    with open(coarse / "results_test_metrics.json") as f:
        res = json.load(f)[f"ours_{it}"]["all"]
    _require(abs(res["PSNR"] - info["test_psnr"]) <= 0.1,
             f"metrics PSNR {res['PSNR']} against phase 10's "
             f"{info['test_psnr']}")
    if lpips_mod.load_weights() is None:
        _require(res["LPIPS"] is None, f"LPIPS {res['LPIPS']} without "
                 "weights")
    it_dir = coarse / "test" / f"ours_{it}"
    renders, gts, _ = read_images(str(it_dir / "renders"), str(it_dir / "gt"))
    params = lpips_mod.init_random_weights(0)
    on_card = lpips_mod.lpips_fn(params=params, device=dev)
    on_cpu = lpips_mod.lpips_fn(params=params, device="cpu")
    lp_card = [on_card(r, g) for r, g in zip(renders, gts)]
    lp_cpu = [on_cpu(r, g) for r, g in zip(renders, gts)]
    lp_err = max(abs(a - b) / abs(b) for a, b in zip(lp_card, lp_cpu))
    _require(lp_err <= 1e-4, f"LPIPS card {lp_card} against CPU {lp_cpu}")
    net = lpips_mod.LPIPS(params).to(dev)
    pair = [torch.from_numpy(x).to(dev).permute(2, 0, 1)[None] * 2 - 1
            for x in (renders[0], gts[0])]
    with torch.no_grad():
        lpips_ms = best_ms(lambda: net(*pair), iters=5)
    rep["metrics"] = {"psnr": res["PSNR"], "phase10_psnr": info["test_psnr"],
                      "ssim": res["SSIM"], "lpips": res["LPIPS"],
                      "seconds": metrics_s, "lpips_random_card": lp_card,
                      "lpips_random_cpu": lp_cpu, "lpips_rel_err": lp_err,
                      "lpips_ms_per_512_pair": lpips_ms}

    # 3. viewer: serve_model on port 0, a client speaking the protocol ------
    lp, _, _, cfg = load_config(str(coarse / "config.yaml"), str(coarse))
    scene = Scene(lp, cfg, load_iteration=-1, device=dev)
    cams = scene.get_test_cameras() + scene.get_train_cameras()[::6]
    msgs = [_wire_1080(c) for c in cams]                    # 1080p
    msgs.append(viewer_mod.request_message(np.eye(4), np.eye(3), 0, 0))
    msgs.append(_wire_1080(cams[1], mod=0.5))
    keep_alive, n_images = len(cams), len(msgs) - 1
    draws.clear()
    srv = viewer_mod.ViewerServer(port=0)
    failed = []

    def serve():
        try:
            viewer_mod.serve_model(str(coarse), max_requests=n_images,
                                   server=srv)
        except Exception as e:               # reported by the client side
            failed.append(repr(e))

    def client():
        th = threading.Thread(target=serve)
        th.start()
        frames, wall_ms = [], []
        with socket.create_connection(("127.0.0.1", srv.bound_port),
                                      timeout=120) as sock:
            for msg in msgs:
                n = msg["resolution_x"] * msg["resolution_y"] * 3
                t0 = time.perf_counter()
                sock.sendall(viewer_mod.frame_message(msg))
                buf = bytearray()
                while len(buf) < n + 4:
                    buf += sock.recv(n + 4 - len(buf))
                m = int.from_bytes(buf[n:n + 4], "little")
                verify = b""
                while len(verify) < m:
                    verify += sock.recv(m - len(verify))
                wall_ms.append((time.perf_counter() - t0) * 1e3)
                _require(verify.decode() == str(coarse), "verify string")
                frames.append(bytes(buf[:n]))
        th.join(timeout=120)
        _require(not failed and not th.is_alive(), f"viewer: {failed}")
        return frames, wall_ms

    with _Wrapped(viewer_mod, "render", wrap_draw):
        (frames, wall_ms), viewer_s = counted("viewer", client,
                                              one_k1_per_render)
    _require(draws.count(0) == n_images,
             f"viewer: dropped counts {draws} for {n_images} requests")
    _require(frames[keep_alive] == b"", "keep-alive answered with an image")
    st = scene.train_state
    mlps, state = st.params.mlps, st.anchor_state()
    busy_ms = []
    for msg, frame in zip(msgs, frames):
        cam_d = viewer_mod.parse_request(msg)
        if cam_d is None:
            continue
        cam = viewer_mod.wire_camera(cam_d, dev)
        mod = cam_d["scaling_modifier"]
        cap = suggest_instance_cap(count_render_instances(
            cam, scene.cfg, mlps, state, scaling_modifier=mod), margin=1.5)
        box = []

        def draw():
            box.append(render(cam, scene.cfg, mlps, state,
                              torch.zeros(3, device=dev), instance_cap=cap,
                              scaling_modifier=mod))
        busy_ms.append(device_profile(draw)["busy_ms"])
        want = viewer_mod.quantize(box[-1]["render"]).tobytes()
        _require(frame == want, "a viewer frame differs from the "
                 "in-process render of its camera")
    rep["viewer"] = {
        "requests": n_images, "size": [1920, 1088], "keep_alive": 1,
        "renders": len(draws), "seconds": viewer_s,
        "wall_ms_send_to_last_byte": wall_ms,
        "wall_ms_p50_1080p": _median(wall_ms[:keep_alive]),
        "device_busy_ms": busy_ms,
        "device_busy_ms_p50": _median(busy_ms)}

    # 4. the explicit model at the flagship's widths ------------------------
    # The neural model gates an anchor's children by the anchor's distance,
    # the baked one each gaussian by its own (the reference's semantics), so
    # a child that straddles a LOD level boundary renders in one and not the
    # other; at the initial zero offsets they coincide, as in the JAX
    # package's test of the bake (`tests/test_pipeline_e2e.py:114-144`).
    ecfg = ModelConfig(name="GaussianLoDModel", feat_dim=32, n_offsets=10,
                       view_dim=0, color_attr="SH1", render_mode="RGB+ED",
                       voxel_size=0.02, fork=2, aerial_levels=2,
                       street_levels=4, standard_dist=8.0)
    pts = random_gaussians(20000, seed=0, extent=0.8,
                           scale_range=(0.01, 0.04))["means"]
    estate = init_anchor_state_from_points(ecfg, pts, device=dev)
    gen = torch.Generator().manual_seed(0)
    live = (torch.arange(estate.capacity) < estate.n)[:, None]
    estate = estate._replace(feat=(torch.randn(estate.feat.shape,
                                               generator=gen) * live).to(dev))
    emlps = init_mlps(ecfg.feat_dim, ecfg.view_dim, ecfg.appearance_dim,
                      ecfg.n_offsets, ecfg.color_dim, generator=gen,
                      device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baked = explicit_mod.bake_explicit(ecfg, emlps, estate)
    bake_ms = (time.perf_counter() - t0) * 1e3
    host_state = estate._replace(**{k: v.cpu() for k, v in
                                    estate._asdict().items()
                                    if torch.is_tensor(v)})
    host_mlps = copy.deepcopy(emlps).cpu()
    got = explicit_mod.decode_explicit(ecfg, emlps, estate)
    want = explicit_mod.decode_explicit(ecfg, host_mlps, host_state)
    op_c, op_h = got["opacity"].cpu(), want["opacity"]
    sure = op_h.abs() > 1e-6
    _require(torch.equal((op_c > 0)[sure], (op_h > 0)[sure]),
             "the bake keeps other rows on the card than on the CPU")
    keep = (op_c > 0) & (op_h > 0)
    bake_err = max(float((got[k].cpu()[keep] - v[keep]).abs().max())
                   for k, v in want.items())
    _require(bake_err <= 1e-5, f"the bake on the card differs from the CPU "
             f"copy's by {bake_err}")
    ply = coarse / "explicit_flagship.ply"
    save_explicit_ply(str(ply), ecfg, baked)
    arrays, _ = load_explicit_ply(str(ply))
    est = explicit_mod.explicit_state_from_arrays(arrays, device=dev)
    ecams = orbit_cameras(4, radius=3.5, height_z=-1.0, width=1920,
                          height=1088, device=dev)
    bg = torch.zeros(3, device=dev)

    def explicit_renders():
        out = []
        for c in ecams:
            t0 = time.perf_counter()
            pkg = explicit_mod.render_explicit(c, ecfg, est, bg)
            torch.cuda.synchronize()
            out.append((pkg, (time.perf_counter() - t0) * 1e3))
        return out

    with torch.no_grad():
        exp, explicit_s = counted("explicit", explicit_renders,
                                  lambda out: launches(k1=len(out)))
        neural = [render(c, ecfg, emlps, estate, bg, add_prefilter=False,
                         instance_cap=suggest_instance_cap(
                             count_render_instances(c, ecfg, emlps, estate,
                                                    add_prefilter=False),
                             margin=1.15)) for c in ecams]
    exp_err = []
    for (pkg, _), nrl in zip(exp, neural):
        _require(int(pkg["n_dropped"]) == 0 == int(nrl["n_dropped"]),
                 "explicit: instances dropped")
        exp_err.append(float((pkg["render"] - nrl["render"]).abs().max()))
    _require(max(exp_err) <= 2e-3, f"explicit renders differ from the "
             f"neural ones by {exp_err}")
    _require(min(float(p["render_alphas"].max()) for p, _ in exp) > 0.5,
             "the explicit model is not visible")
    rep["explicit"] = {
        "anchors": estate.n, "baked_gaussians": int(baked["xyz"].shape[0]),
        "decoded": estate.n * ecfg.n_offsets, "bake_ms": bake_ms,
        "bake_err_vs_cpu": bake_err, "render_ms": [t for _, t in exp],
        "max_abs_err_vs_neural": exp_err, "size": [1920, 1088]}

    # 5. mesh export of the 2DGS model: K3 once per train view -------------
    timed, fused = {}, []

    def wrap_timed(name):
        def make(orig):
            def fn(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(*args, **kw)
                torch.cuda.synchronize()
                timed[name] = timed.get(name, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                if name == "fuse":
                    fused.append((args, kw, out))
                return out
            return fn
        return make

    with _Wrapped(export_mod, "render_depths", wrap_timed("render")), \
            _Wrapped(export_mod, "fuse_tsdf", wrap_timed("fuse")), \
            _Wrapped(export_mod, "marching_tetrahedra",
                     wrap_timed("extract")), \
            _Wrapped(export_mod, "largest_component",
                     wrap_timed("largest_component")):
        _, mesh_s = counted("mesh export", lambda: export_mod.main(
            ["-m", str(surfel), "--resolution", "128"]),
            lambda _: launches(k3=info["n_train"]))
    verts, faces = read_mesh_ply(
        str(surfel / f"mesh_iteration_{info['its_2d']}.ply"))
    _require(faces.shape[0] > 0 and bool(np.isfinite(verts).all()),
             f"mesh: {verts.shape[0]} vertices, {faces.shape[0]} faces")
    (args, kw, (tsdf, weight)), = fused
    t0 = time.perf_counter()
    tsdf_h, weight_h = export_mod.fuse_tsdf(*args, **{**kw, "device": "cpu"})
    fuse_cpu_ms = (time.perf_counter() - t0) * 1e3
    tsdf_err = float(np.abs(tsdf - tsdf_h).max())
    _require(tsdf_err <= 1e-9 and np.array_equal(weight, weight_h),
             f"the card's TSDF differs from the CPU copy's by {tsdf_err}")
    rep["mesh_export"] = {
        "views": info["n_train"], "grid": list(tsdf.shape),
        "observed_voxels": int((weight > 0).sum()),
        "vertices": int(verts.shape[0]), "faces": int(faces.shape[0]),
        "seconds": mesh_s, "render_ms": timed["render"],
        "fuse_ms": timed["fuse"], "fuse_cpu_copy_ms": fuse_cpu_ms,
        "extract_ms": timed["extract"] + timed["largest_component"],
        "tsdf_max_abs_err_vs_cpu": tsdf_err}
    return rep, tuple(phase)


# keys of chunks512.yaml's data_params that only the partition reads
_PARTITION_KEYS = ("n_width", "n_height", "overlap_area", "visible_rate",
                   "xyz_plane")


def _chunks(root, info, kernels, dev, coarse_its=300, fine_its=150):
    """Phase 12: the large-scene pipeline on phase 10's flagship512 dataset
    (`info["data"]`) in a temporary working directory, where the chunk
    configs' relative outputs/... paths resolve: `cli.partition` of
    configs/synthetic/chunks512.yaml, `train_chunks` coarse then fine for
    each chunk in this process through the generated configs, unedited,
    and `cli.merge` with the evaluation of the merged model on the 4 test
    views; then one 256x256 view of the merged model through K1 against
    the dense oracle. Each job and the merge run with every count set to 0
    just before and read just after. Returns the phase's report and its
    launches."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import yaml
    from horizongs_tpu_torch.cli import train as train_cli_mod
    from horizongs_tpu_torch.cli.merge import main as merge_main
    from horizongs_tpu_torch.cli.partition import main as partition_main
    from horizongs_tpu_torch.data import scene as scene_mod
    from horizongs_tpu_torch.data.synthetic import lookat_camera
    from horizongs_tpu_torch.io.checkpoints import (
        load_explicit_ply, load_mlp_checkpoints, search_max_iteration)
    from horizongs_tpu_torch.models.config import ModelConfig
    from horizongs_tpu_torch.models.explicit import (
        explicit_state_from_arrays, render_explicit)
    from horizongs_tpu_torch.parallel import chunks as chunks_mod
    from horizongs_tpu_torch.train import evaluate as evaluate_mod
    from horizongs_tpu_torch.train import trainer as trainer_mod
    n_k = len(kernels)
    zero = (0,) * n_k
    phase = [0] * n_k
    data = info["data"]
    rep = {}

    def last_iteration(mdir):
        it = search_max_iteration(os.path.join(mdir, "point_cloud"))
        return os.path.join(mdir, "point_cloud", f"iteration_{it}")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_chunks_"))
    cwd = os.getcwd()
    try:
        os.chdir(work)
        # 1. partition: host numpy, no kernel --------------------------------
        with open(root / "configs" / "synthetic" / "chunks512.yaml") as f:
            cfg = yaml.safe_load(f)
        cfg["data_params"]["source_path"] = data
        cfg["chunk_coarse"]["optim_params"]["iterations"] = coarse_its
        cfg["chunk_fine"]["optim_params"]["iterations"] = fine_its
        os.makedirs("cfg")
        with open("cfg/chunks512.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        _reset(kernels)
        t0 = time.perf_counter()
        rc = partition_main(["--config", "cfg/chunks512.yaml"])
        partition_ms = (time.perf_counter() - t0) * 1e3
        _require(rc == 0 and _counts(kernels) == zero,
                 f"partition returned {rc}, launched {_counts(kernels)}")
        with open(os.path.join(data, "chunks", "partitions.json")) as f:
            meta = json.load(f)
        parts = {}
        for cid, c in meta["chunks"].items():
            with open(os.path.join(data, "chunks", cid,
                                   "transforms.json")) as f:
                frames = len(json.load(f)["frames"])
            parts[cid] = {"cameras": c["n_cameras"], "frames": frames,
                          "points": c["n_points"],
                          "true_bounds": c["true_bounds"],
                          "bounds": c["bounds"]}
            _require(frames > 0 and c["n_points"] > 0,
                     f"chunk {cid}: {frames} frames, {c['n_points']} points")
            print(f"chunks: {cid}: {c['n_cameras']} cameras, {frames} "
                  f"frames written, {c['n_points']} points, true bounds "
                  f"{c['true_bounds']}, bounds {c['bounds']}", flush=True)
        with open(os.path.join("cfg", "chunk_coarse",
                               f"{next(iter(meta['chunks']))}.yaml")) as f:
            kw = yaml.safe_load(f)["model_params"]["model_config"]["kwargs"]
        lod = {k: kw[k] for k in ("standard_dist", "aerial_levels",
                                  "street_levels")}
        print(f"chunks: partition {partition_ms:.1f} ms into "
              f"{len(parts)} chunks; estimated LOD {lod}", flush=True)
        rep["partition"] = {"ms": partition_ms, "chunks": parts,
                            "lod": lod}

        # 2. each chunk coarse then fine, in this process --------------------
        out_root = os.path.join("outputs", "synthetic", "chunks512")
        cfgs, mps = [], []
        for cid in meta["chunks"]:
            for stage in ("chunk_coarse", "chunk_fine"):
                cfgs.append(os.path.join("cfg", stage, f"{cid}.yaml"))
                mps.append(os.path.join(out_root, stage, cid))
        jobs, runs, renders, scenes, fine_epochs = [], [], [], [], []

        def wrap_main(orig):
            def main(argv):
                n_runs, n_renders = len(runs), len(renders)
                _reset(kernels)
                t0 = time.perf_counter()
                rc = orig(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                total = _counts(kernels)
                for i, n in enumerate(total):
                    phase[i] += n
                jobs.append({"config": argv[1], "rc": rc, "total": total,
                             "seconds": seconds, "runs": runs[n_runs:],
                             "renders": renders[n_renders:],
                             "scene": scenes[-1]})
                return rc
            return main

        def wrap_train(orig):
            def train(self, *args, **kw):
                before = _counts(kernels)
                t0 = time.perf_counter()
                hist = orig(self, *args, **kw)
                torch.cuda.synchronize()
                runs.append({"trainer": self, "hist": hist,
                             "seconds": time.perf_counter() - t0,
                             "launches": tuple(a - b for a, b in zip(
                                 _counts(kernels), before))})
                return hist
            return train

        def wrap_render(orig):
            def render(*args, **kw):
                pkg = orig(*args, **kw)
                renders.append(int(pkg["n_dropped"]))
                return pkg
            return render

        class TimedScene(scene_mod.Scene):
            def __init__(self, *args, **kw):
                t0 = time.perf_counter()
                super().__init__(*args, **kw)
                scenes.append({"scene": self,
                               "seconds": time.perf_counter() - t0})

        def wrap_densify(orig):
            return _checked_densify(orig, lambda: scenes[-1]["scene"].base,
                                    fine_epochs, dev)

        t0 = time.perf_counter()
        with _Wrapped(train_cli_mod, "main", wrap_main), \
                _Wrapped(trainer_mod.Trainer, "train", wrap_train), \
                _Wrapped(trainer_mod, "run_densify", wrap_densify), \
                _Wrapped(evaluate_mod, "render", wrap_render), \
                _Wrapped(scene_mod, "Scene", lambda orig: TimedScene):
            chunks_mod.train_chunks(cfgs, mps, ["--disable_tb"])
        train_s = time.perf_counter() - t0
        _require(len(jobs) == len(cfgs), f"{len(jobs)} chunk jobs ran")
        job_rep = []
        for job, mdir in zip(jobs, mps):
            name = job["config"]
            _require(job["rc"] == 0 and len(job["runs"]) == 1,
                     f"{name}: rc {job['rc']}, {len(job['runs'])} runs")
            run, sc = job["runs"][0], job["scene"]["scene"]
            tr, hist = run["trainer"], run["hist"]
            n = len(hist)
            fine = "chunk_fine" in name
            _require(n == (fine_its if fine else coarse_its),
                     f"{name}: {n} iterations")
            _require(run["launches"] == (n, n) + zero[2:],
                     f"{name}: kernels launched {run['launches']} in {n} "
                     f"iterations")
            ev = tuple(t - r for t, r in zip(job["total"], run["launches"]))
            views = len(sc.get_test_cameras() or sc.get_train_cameras())
            _require(ev == (len(job["renders"]),) + zero[1:]
                     and job["renders"].count(0) == views,
                     f"{name}: evaluation launched {ev} for {views} views, "
                     f"dropped counts {job['renders']}")
            _require(all(math.isfinite(x) for x in hist),
                     f"{name}: a loss is not finite")
            overflows = tr.records["overflows"]
            _require(all(o["widened"] or o["margin"] * 1.5 >
                         tr.MARGIN_CEIL for o in overflows),
                     f"{name}: an overflow was not recalibrated {overflows}")
            dens = tr.records["densify"]
            _require(len(dens) >= (1 if fine else 2),
                     f"{name}: densify epochs {dens}")
            ply = os.path.join(last_iteration(mdir),
                               "point_cloud_explicit.ply")
            _require(os.path.isfile(ply), f"{name}: no {ply}")
            if fine:
                # the generated config's model directory, unedited
                coarse_dir = mdir.replace("chunk_fine", "chunk_coarse")
                _require(sc.stage == "fine" and sc.frozen_mlps
                         and sc.lp.pretrained_checkpoint == coarse_dir,
                         f"{name}: not a fine stage from {coarse_dir}")
                coarse_mlps = load_mlp_checkpoints(
                    last_iteration(coarse_dir), device=dev)
                _require(all(torch.equal(a, b) for a, b in zip(
                    tr.state.params.mlps.parameters(),
                    coarse_mlps.parameters())),
                    f"{name}: the frozen MLPs differ from the coarse model's")
            it_ms = tr.records["iteration_ms"]
            job_rep.append({
                "config": name, "scene_load_s": job["scene"]["seconds"],
                "iterations": n, "train_s": run["seconds"],
                "iterations_per_s": n / run["seconds"],
                "iteration_ms_p50": _median(it_ms),
                "iteration_ms_p90": _pct(it_ms, 0.9),
                "densify_epochs": [{k: d.get(k) for k in (
                    "iteration", "added", "pruned", "decision_ms",
                    "grow_ms", "repack_ms")} for d in dens],
                "overflows": len(overflows),
                "anchors_final": int(tr.state.n),
                "eval_renders": len(job["renders"]), "eval_views": views,
                "job_s": job["seconds"],
                "launches_train": run["launches"][:4],
                "launches_eval": ev[:4]})
            print(f"chunks: {name}: scene {job['scene']['seconds']:.2f} s, "
                  f"{n} iterations at {n / run['seconds']:.2f} it/s (p50 "
                  f"{_median(it_ms):.2f}, p90 {_pct(it_ms, 0.9):.2f} ms), "
                  f"{len(dens)} densify epochs "
                  f"{[(d['iteration'], d['added'], d['pruned']) for d in dens]}"
                  f", {int(tr.state.n)} anchors", flush=True)
        _require(fine_epochs and all(e["equal_to_base"] for e in fine_epochs),
                 f"fine: coarse rows after the epochs {fine_epochs}")
        rep["train"] = {"seconds": train_s, "jobs": job_rep,
                        "fine_epochs": fine_epochs}

        # 3. merge and its evaluation ----------------------------------------
        ev_cfg = {k: v for k, v in cfg["data_params"].items()
                  if k not in _PARTITION_KEYS}
        with open("cfg/eval.yaml", "w") as f:
            yaml.safe_dump({"model_params": ev_cfg}, f)
        passes = {}

        def wrap_consolidate(orig):
            def consolidate(*args, **kw):
                passes["start"] = time.perf_counter()
                path = orig(*args, **kw)
                passes["end"] = time.perf_counter()
                return path
            return consolidate

        class TimedWriter(chunks_mod.PlyStreamWriter):
            def __init__(self, *args, **kw):
                passes["pass2"] = time.perf_counter()
                super().__init__(*args, **kw)

        merge_renders = []

        def wrap_explicit(orig):
            def render(*args, **kw):
                pkg = orig(*args, **kw)
                merge_renders.append(int(pkg["n_dropped"]))
                return pkg
            return render

        _reset(kernels)
        t0 = time.perf_counter()
        with _Wrapped(chunks_mod, "consolidate_chunks", wrap_consolidate), \
                _Wrapped(chunks_mod, "PlyStreamWriter",
                         lambda orig: TimedWriter), \
                _Wrapped(evaluate_mod, "render_explicit", wrap_explicit):
            rc = merge_main(["-m", out_root, "--source_path", data,
                             "--eval_config", "cfg/eval.yaml"])
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        launched = _counts(kernels)
        for i, n in enumerate(launched):
            phase[i] += n
        _require(rc == 0, f"merge returned {rc}")
        n_test = info["n_test"]
        _require(launched == (len(merge_renders),) + zero[1:]
                 and merge_renders.count(0) == n_test,
                 f"merge: kernels launched {launched} for {n_test} views, "
                 f"dropped counts {merge_renders}")

        # the merged PLY against the chunks', recounted on the card
        merged_dir = os.path.join(out_root, "merged_model")
        merged_ply = os.path.join(last_iteration(merged_dir),
                                  "point_cloud_explicit.ply")
        merged, merged_info = load_explicit_ply(merged_ply)
        kept, cropped, infos = {}, [], []
        inside = torch.zeros(merged["xyz"].shape[0], dtype=torch.bool,
                             device=dev)
        mxyz = torch.from_numpy(merged["xyz"]).to(dev)
        for cid, c in meta["chunks"].items():
            arrays, chunk_info = load_explicit_ply(os.path.join(
                last_iteration(os.path.join(out_root, "chunk_fine", cid)),
                "point_cloud_explicit.ply"))
            (x0, x1), (y0, y1) = c["true_bounds"]
            xyz = torch.from_numpy(arrays["xyz"]).to(dev)
            mask = ((xyz[:, 0] >= x0) & (xyz[:, 0] <= x1)
                    & (xyz[:, 1] >= y0) & (xyz[:, 1] <= y1))
            kept[cid] = int(mask.sum())
            m = mask.cpu().numpy()
            cropped.append({k: v[m] for k, v in arrays.items()})
            infos.append(chunk_info)
            inside |= ((mxyz[:, 0] >= x0) & (mxyz[:, 0] <= x1)
                       & (mxyz[:, 1] >= y0) & (mxyz[:, 1] <= y1))
        n_rows = merged["xyz"].shape[0]
        _require(n_rows == sum(kept.values()) > 0,
                 f"merged rows {n_rows} against kept {kept}")
        differ = [k for k in merged if not np.array_equal(
            merged[k], np.concatenate([c[k] for c in cropped]))]
        _require(not differ, f"merged arrays differ from the cropped "
                 f"chunks' concatenation: {differ}")
        _require(bool(inside.all()), "a merged gaussian lies outside the "
                 "chunks' true bounds")
        _require(all(i == merged_info for i in infos),
                 f"merged obj_info {merged_info} against the chunks' {infos}")
        with open(os.path.join(merged_dir, "results_test.json")) as f:
            res = next(iter(json.load(f).values()))["all"]
        _require(res["n_views"] == n_test and math.isfinite(res["PSNR"])
                 and math.isfinite(res["SSIM"]), f"merged results {res}")
        merge_rep = {
            "seconds": merge_s,
            "pass1_ms": (passes["pass2"] - passes["start"]) * 1e3,
            "pass2_ms": (passes["end"] - passes["pass2"]) * 1e3,
            "rows_kept": kept, "rows_merged": n_rows,
            "ply_bytes": os.path.getsize(merged_ply),
            "obj_info": merged_info, "eval_renders": len(merge_renders),
            "launches": launched[:4], "test_psnr": res["PSNR"],
            "test_ssim": res["SSIM"],
            "phase10_coarse_test_psnr": info["test_psnr"],
            "phase10_fine_test_psnr": info["fine_test_psnr"]}

        # one 256x256 view of the merged model, K1 against the dense oracle
        mcfg = ModelConfig.from_dict(ev_cfg["model_config"])
        mcfg = dataclasses.replace(mcfg, **{
            k: type(getattr(mcfg, k))(merged_info[k])
            for k in ("standard_dist", "aerial_levels", "street_levels")})
        est = explicit_state_from_arrays(merged, device=dev)
        cam = lookat_camera(width=256, height=256, eye=(0, 0, -4),
                            device=dev)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            k1 = render_explicit(cam, mcfg, est, bg)
            dense = render_explicit(cam, mcfg, est, bg, rasterizer="dense")
        _require(int(k1["n_dropped"]) == 0, "merged view: dropped")
        view_err = {k: float((k1[k] - dense[k]).abs().max())
                    for k in ("render", "render_alphas")}
        _require(max(view_err.values()) <= 2e-4
                 and float(dense["render_alphas"].max()) > 0.5,
                 f"merged view: K1 against the dense oracle {view_err}")
        merge_rep["view_256_max_abs_err"] = view_err
        rep["merge"] = merge_rep
        print(f"chunks: merge pass 1 {merge_rep['pass1_ms']:.1f} ms, pass 2 "
              f"{merge_rep['pass2_ms']:.1f} ms, rows kept {kept} -> {n_rows} "
              f"({merge_rep['ply_bytes']} B); merged test PSNR "
              f"{res['PSNR']:.3f} SSIM {res['SSIM']:.4f} (phase 10: coarse "
              f"{info['test_psnr']:.3f}, fine {info['fine_test_psnr']:.3f}); "
              f"256x256 view against the dense oracle {view_err}",
              flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return rep, tuple(phase)


# ---------------------------------------------------------------------------
# phase 13: the mesh (parallel/step.py on torch.distributed)
# ---------------------------------------------------------------------------

def _mesh_cli_worker(out_dir, *argv):
    """`python -m torch.distributed.run ... chip_smoke.py --mesh-cli <dir>
    <cli.train arguments>`: one rank of the train CLI, its K1-K4 counts
    set to 0 just before and read just after, its trainer's figures in
    <dir>/rank<RANK>.json."""
    import torch
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from horizongs_tpu_torch.cli.train import main as train_main
    from horizongs_tpu_torch.ops import raster2d, raster3d
    from horizongs_tpu_torch.train import evaluate as evaluate_mod
    from horizongs_tpu_torch.train import trainer as trainer_mod
    kernels = (raster3d.KERNEL, raster3d.KERNEL_BWD, raster2d.KERNEL_2D,
               raster2d.KERNEL_2D_BWD)
    runs, renders = [], []

    def wrap_train(orig):
        def train(self, *a, **kw):
            t0 = time.perf_counter()
            hist = orig(self, *a, **kw)
            torch.cuda.synchronize()
            runs.append((self, hist, time.perf_counter() - t0))
            return hist
        return train

    def wrap_render(orig):
        def render(*a, **kw):
            pkg = orig(*a, **kw)
            renders.append(int(pkg["n_dropped"]))
            return pkg
        return render
    _reset(kernels)
    t0 = time.perf_counter()
    with _Wrapped(trainer_mod.Trainer, "train", wrap_train), \
            _Wrapped(evaluate_mod, "render", wrap_render):
        rc = train_main(list(argv))
    seconds = time.perf_counter() - t0
    tr, hist, train_s = runs[-1]
    rank = int(os.environ.get("RANK", 0))
    it_ms, step_ms = tr.records["iteration_ms"], tr.records["step_ms"]
    rep = {"rc": rc, "rank": rank, "launches": _counts(kernels),
           "iterations": len(hist), "loss_first": hist[0],
           "loss_last": hist[-1], "finite": all(map(math.isfinite, hist)),
           "densify": tr.records["densify"],
           "overflows": tr.records["overflows"],
           "widened_or_capped": all(
               o["widened"] or max(o["margin"], o["band_margin"]) * 1.5
               > tr.MARGIN_CEIL for o in tr.records["overflows"]),
           "eval_renders": len(renders), "eval_dropped": renders,
           "seconds": seconds, "train_s": train_s,
           "iterations_per_s": len(hist) / train_s,
           "iteration_ms_p50": _median(it_ms),
           "step_ms_p50": _median(step_ms),
           "mesh": None if tr.mesh is None else [tr.mesh.shape["data"],
                                                 tr.mesh.shape["model"]],
           "backend": tr.mesh.backend if tr.mesh is not None else None}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rep, f)
    return rc


def _spawn(cmds, env, timeout):
    """Start every command together, wait for all; each must exit 0.
    Returns their outputs."""
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        _require(p.returncode == 0, f"{' '.join(map(str, p.args[:6]))} "
                 f"exited {p.returncode}:\n{o[-6000:]}")
    return outs


def _band_kernels_vs_plain(path, dev):
    """The forward and backward kernel of one training step, on the
    arguments `tools/mesh_check --capture` or `tools/convergence_check`
    wrote (of a sharded step: a band's rows, K3 and K4 with the band's
    first row), against their plain versions at phases 4/5's
    tolerances. Returns (ok, errors)."""
    import torch
    from horizongs_tpu_torch.ops import raster2d, raster3d
    cap = torch.load(path, map_location=dev, weights_only=False)
    f, b = cap["fwd"], cap["bwd"]
    if cap["gs"] == "2D":
        ok1, e1 = _compare_k3(raster2d.rasterize2d_fwd(*f),
                              raster2d.rasterize2d_fwd_plain(*f), 1e-4, f,
                              row0=f[5])
        ok2, e2 = _compare_k2(raster2d.rasterize2d_bwd(*b),
                              raster2d.rasterize2d_bwd_plain(*b))
    else:
        ok1, e1 = _compare_k1(raster3d.rasterize_fwd(*f),
                              raster3d.rasterize_fwd_plain(*f), 1e-4, f)
        ok2, e2 = _compare_k2(raster3d.rasterize_bwd(*b),
                              raster3d.rasterize_bwd_plain(*b))
    torch.cuda.synchronize()
    shape = {"n_tiles_x": f[3], "n_tiles_y": f[4], "records": f[0].shape[0],
             "instances": int(f[2][-1])}
    if cap["gs"] == "2D":
        shape["row0"] = f[5]
    return ok1 and ok2, {"shape": shape, "fwd": e1, "bwd": e2}


def _mesh_check(root, nproc, cases, capture, out, steps):
    """`tools/mesh_check` through `torch.distributed.run` in nproc ranks on
    this card (NCCL for one rank, gloo for more: `parallel/mesh`); it
    exits 1 unless every case held. Returns each rank's record and the
    seconds it took."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m",
           "horizongs_tpu_torch.tools.mesh_check", "--out", str(out),
           "--steps", str(steps)]
    for c in cases:
        cmd += ["--case", c]
    for c in capture:
        cmd += ["--capture", c]
    t0 = time.perf_counter()
    _spawn([cmd], dict(os.environ, PYTHONPATH=str(root)), 600)
    ranks = []
    for r in range(nproc):
        with open(out / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def _mesh_steps(root, kernels, dev):
    """Phase 13, the steps at 1920x1088 through `tools/mesh_check` (the
    flagship model of phase 6): a 1x1 mesh on NCCL, then 1x2 (3DGS bands,
    the replicated fallback, 2DGS bands) and 2x1 (two views, one view
    twice at weight 1/2) meshes of two gloo ranks on this card. Each
    case's gradients and losses are held to the single-device `TrainStep`
    on the same state and views, inside mesh_check; here each rank's
    launches are checked and the band kernels held to their plain
    versions on the arguments the steps gave them. Returns the report and
    the K1-K4 launches (the gradient step and the timed steps, summed over
    ranks)."""
    import shutil
    import tempfile
    launches = [0] * len(kernels)
    idx = {"3D": (0, 1), "2D": (2, 3)}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    rep = {"card": _smi("name,power.limit")}
    try:
        runs = [("nccl", 1, ["1x1"], ["1x1"], 10),
                ("gloo", 2, ["1x2", "1x2:replicated", "1x2:2D", "2x1",
                             "2x1:duplicate"], ["1x2", "1x2:2D", "2x1"], 5)]
        for backend, nproc, cases, capture, steps in runs:
            out = work / f"world{nproc}"
            ranks, seconds = _mesh_check(root, nproc, cases, capture, out,
                                         steps)
            got = [r["backend"] for r in ranks]
            _require(got == [backend] * nproc, f"mesh backends {got}")
            rep[f"world{nproc}"] = {"seconds": seconds, "backend": backend,
                                    "threads": ranks[0]["threads"],
                                    "cases": {}}
            for name in cases:
                gs = "2D" if ":2D" in name else "3D"
                c0 = ranks[0]["cases"][name]
                _require(c0["held"], f"mesh {name}: not held: losses "
                         f"{c0['loss']} vs {c0['loss_single_device']}, "
                         f"worst gradient {c0['grad_worst_share_of_max']} x "
                         f"max, dropped {c0['dropped_any']}")
                per_rank = []
                for r, rk in enumerate(ranks):
                    c = rk["cases"][name]
                    _require(c["launches_grad"] == [1, 1]
                             and c["launches_timed"] == [steps, steps],
                             f"mesh {name} rank {r}: launched "
                             f"{c['launches_grad']}, {c['launches_timed']}")
                    _require(max(c["dropped_timed"]) == 0 and all(
                        map(math.isfinite, c["losses"])),
                        f"mesh {name} rank {r}: dropped "
                        f"{c['dropped_timed']}, losses {c['losses']}")
                    for j, i in enumerate(idx[gs]):
                        launches[i] += c["launches_grad"][j] \
                            + c["launches_timed"][j]
                    entry = {k: c[k] for k in (
                        "instance_cap", "band_cap",
                        "step_ms_p50", "exchange", "collectives_ms_per_step",
                        "records_local", "records_received", "n_instances",
                        "band_instances_counted", "launches_grad",
                        "launches_timed", "profile") if k in c}
                    if name in capture:
                        ok, errs = _band_kernels_vs_plain(
                            out / f"capture_{name.replace(':', '_')}_rank"
                                  f"{r}.pt", dev)
                        _require(ok, f"mesh {name} rank {r}: a kernel "
                                 f"disagrees with its plain version on the "
                                 f"band's inputs: {errs}")
                        entry["kernels_vs_plain"] = errs
                    per_rank.append(entry)
                rec = {k: c0[k] for k in (
                    "loss", "loss_single_device", "grad_worst_share_of_max",
                    "band_matrix", "band_loads", "single_device") if k in c0}
                rec["per_rank"] = per_rank
                rep[f"world{nproc}"]["cases"][name] = rec
                t = per_rank[0]
                line = (f"mesh: {name} {backend} loss {c0['loss'][0]:.6f} "
                        f"(single device {c0['loss_single_device'][0]:.6f})"
                        f", gradients within "
                        f"{c0['grad_worst_share_of_max']:.2e} x max; step "
                        f"p50 " + " / ".join(f"{x['step_ms_p50']:.2f}"
                                              for x in per_rank)
                        + f" ms, busy " + " / ".join(
                            f"{x['profile']['device_busy_ms']:.3f}"
                            for x in per_rank)
                        + f" ms, exchange "
                        f"{t['exchange']['bytes_per_step'] / 1e6:.2f} MB "
                        + " / ".join(f"{x['exchange']['ms_per_step']:.2f}"
                                     for x in per_rank)
                        + " ms a step"
                        + (" (host-staged)" if t["exchange"]["host_staged"]
                           else "")
                        + ", collectives " + " / ".join(
                            f"{x['collectives_ms_per_step']:.2f}"
                            for x in per_rank) + " ms")
                if "band_loads" in c0:
                    lo = c0["band_loads"]
                    line += (", records local " + " / ".join(
                        str(x["records_local"]) for x in per_rank)
                        + ", received " + " / ".join(
                            str(x["records_received"]) for x in per_rank))
                    line += (f", band loads {lo} (max/mean "
                             f"{max(lo) / (sum(lo) / len(lo)):.3f})")
                if "single_device" in c0:
                    sd = c0["single_device"]
                    line += (f"; TrainStep p50 {sd['step_ms_p50']:.2f} ms, "
                             f"busy {sd['profile']['device_busy_ms']:.3f}")
                if any("kernels_vs_plain" in x for x in per_rank):
                    line += "; K1-K4 on the band's inputs held to plain"
                print(line, flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rep, launches


def _mesh_cli(root, info, kernels, dev, its=300, resume_its=20):
    """Phase 13, the train CLI: `--mesh 1x2` through
    `torch.distributed.run` on phase 10's flagship512 dataset (two gloo
    ranks on this card; densify epochs and a sharded checkpoint), then a
    resume from that checkpoint at `--mesh 1x1` (NCCL), each with the
    test-set evaluation. Every rank's K1-K4 counts are set to 0 just
    before its run and read after. Returns the report and the launches
    summed over ranks."""
    import shutil
    import tempfile

    import yaml
    n_k = len(kernels)
    launches = [0] * n_k
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_meshcli_"))
    env = dict(os.environ, PYTHONPATH=str(root))
    rep = {}
    try:
        with open(root / "configs" / "synthetic" / "flagship512.yaml") as f:
            c = yaml.safe_load(f)
        c["model_params"]["source_path"] = info["data"]
        cfg_path = work / "flagship512.yaml"
        with open(cfg_path, "w") as f:
            yaml.safe_dump(c, f)

        def launch(name, nproc, *argv):
            out_dir = work / f"ranks_{name}"
            t0 = time.perf_counter()
            outs = _spawn([[sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc_per_node", str(nproc),
                            str(root / "chip_smoke.py"), "--mesh-cli",
                            str(out_dir), "--config", str(cfg_path),
                            "--model_path", str(work / name),
                            "--disable_tb", *argv]], env, 900)
            seconds = time.perf_counter() - t0
            ranks = []
            for r in range(nproc):
                with open(out_dir / f"rank{r}.json") as f:
                    ranks.append(json.load(f))
            return ranks, seconds, outs[0]

        def check(name, ranks, n_its):
            for r in ranks:
                _require(r["rc"] == 0 and r["finite"],
                         f"mesh CLI {name} rank {r['rank']}: rc {r['rc']}, "
                         f"finite {r['finite']}")
                _require(r["iterations"] == n_its,
                         f"mesh CLI {name}: {r['iterations']} iterations")
                _require(r["widened_or_capped"],
                         f"mesh CLI {name}: an overflow was not "
                         f"recalibrated: {r['overflows']}")
                ev = r["eval_renders"] if r["rank"] == 0 else 0
                want = (n_its + ev, n_its, 0, 0)
                _require(tuple(r["launches"][:4]) == want,
                         f"mesh CLI {name} rank {r['rank']}: launched "
                         f"{r['launches']}, expected {want}")
                for i, n in enumerate(r["launches"]):
                    launches[i] += n

        r12, s12, log12 = launch("mesh1x2", 2, "--mesh", "1x2",
                                 "--iterations", str(its),
                                 "--checkpoint_iterations", str(its))
        check("1x2", r12, its)
        _require(all(r["backend"] == "gloo" for r in r12),
                 f"1x2 backends {[r['backend'] for r in r12]}")
        _require(len(r12[0]["densify"]) >= 1,
                 f"mesh CLI 1x2: densify epochs {r12[0]['densify']}")
        ck = work / "mesh1x2" / f"chkpnt{its}_sharded"
        _require((ck / "manifest.json").is_file(),
                 "mesh CLI 1x2: no sharded checkpoint")
        with open(ck / "manifest.json") as f:
            man = json.load(f)
        with open(work / "mesh1x2" / "results_test.json") as f:
            res12 = json.load(f)[f"ours_{its}"]["all"]
        _require(math.isfinite(res12["PSNR"]), f"1x2 test PSNR {res12}")
        r11, s11, log11 = launch("resume1x1", 1, "--mesh", "1x1",
                                 "--start_checkpoint", str(ck),
                                 "--iterations", str(its + resume_its))
        check("resume 1x1", r11, resume_its)
        _require(r11[0]["backend"] == "nccl",
                 f"1x1 backend {r11[0]['backend']}")
        with open(work / "resume1x1" / "results_test.json") as f:
            res11 = json.load(f)[f"ours_{its + resume_its}"]["all"]
        _require(math.isfinite(res11["PSNR"]), f"resume test PSNR {res11}")
        rep = {"mesh1x2": {"iterations": its, "seconds": s12,
                           "ranks": r12, "checkpoint_manifest": man,
                           "test_psnr": res12["PSNR"],
                           "test_ssim": res12["SSIM"]},
               "resume1x1": {"iterations": resume_its, "seconds": s11,
                             "ranks": r11, "test_psnr": res11["PSNR"],
                             "test_ssim": res11["SSIM"]},
               "phase10_test_psnr": info["test_psnr"]}
        print(f"mesh: train CLI --mesh 1x2 (gloo, one card): {its} "
              f"iterations at {r12[0]['iterations_per_s']:.2f} it/s, "
              f"densify epochs {len(r12[0]['densify'])}, overflows "
              f"{len(r12[0]['overflows'])}, test PSNR {res12['PSNR']:.3f} "
              f"(phase 10 coarse {info['test_psnr']:.3f}), {s12:.1f} s; "
              f"resume at --mesh 1x1 (nccl) {resume_its} iterations from "
              f"capacity {man['capacity']}: test PSNR {res11['PSNR']:.3f}, "
              f"{s11:.1f} s", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rep, launches


# ---------------------------------------------------------------------------
# phase 14: the rest of the port (the native loader, the tools)
# ---------------------------------------------------------------------------

def _write_points3d(path, n, seed=0, track=2):
    """A COLMAP points3D.bin of n points from a seed, each with a track
    of `track` observations, written in one block."""
    import numpy as np
    rec = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                    ("err", "<f8"), ("tlen", "<u8"),
                    ("track", "<i4", 2 * track)])
    rng = np.random.default_rng(seed)
    a = np.zeros(n, rec)
    a["id"] = rng.permutation(n) + 1
    a["xyz"] = rng.normal(0, 50, (n, 3))
    a["rgb"] = rng.integers(0, 256, (n, 3))
    a["err"] = rng.uniform(0, 2, n)
    a["tlen"] = track
    a["track"] = rng.integers(0, 1000, (n, 2 * track))
    with open(path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        a.tofile(f)


def _within_ulp(a, b):
    import numpy as np
    return bool((np.abs(a - b)
                 <= np.spacing(np.maximum(np.abs(a), np.abs(b)))).all())


def _native_loader(info, dev, reps=3, n_points=1_000_000):
    """Phase 14a on phase 10's dataset: the native loader's build, or the
    reason it has none. With it: the 28 views through `camera_list` at
    `resolution: 1` against PIL (within an ulp) and at `resolution: 2`
    against `load_image_rgba` and `ImagePool.load_many` (bit for bit), and
    a 1M-point points3D.bin parsed natively against the Python walk. Timed
    either way, for each loader this machine has (PIL always, the native
    one when it built): `camera_list`'s wall time for the 28 views, ms per
    image at both resolutions, and the points3D parse."""
    import shutil
    import tempfile

    import numpy as np
    from horizongs_tpu_torch import native
    from horizongs_tpu_torch.config import make_model_params
    from horizongs_tpu_torch.data import camera_build, colmap
    from horizongs_tpu_torch.data.readers import read_blender_scene
    t0 = time.perf_counter()
    ok = native.available()
    rep = {"available": ok, "build_s": time.perf_counter() - t0}
    if ok:
        rep["library"] = native.library_path().name
    else:
        rep["reason"] = native.unavailable_reason()
        print(f"native: unavailable: {rep['reason']}", flush=True)
    sc = read_blender_scene(info["data"])
    infos = sc.train_cameras + sc.test_cameras
    rep["views"] = len(infos)
    loaders = {"pil": _Wrapped(native, "available",
                               lambda orig: (lambda: False))}
    if ok:
        loaders["native"] = contextlib.nullcontext()

    def cams(res):
        return camera_build.camera_list(
            infos, make_model_params(resolution=res, data_format="blender"),
            1.0, device=dev)
    got = {}
    for name, ctx in loaders.items():
        with ctx:
            t0 = time.perf_counter()
            got[name] = {1: cams(1)}
            rep[f"camera_list_s_{name}"] = time.perf_counter() - t0
            got[name][2] = cams(2)
            for res in (1, 2):
                sizes = [(c.width, c.height) for c in got[name][res]]
                t0 = time.perf_counter()
                for _ in range(reps):
                    for i, wh in zip(infos, sizes):
                        camera_build._load_image(i.image_path, wh)
                rep[f"ms_per_image_{name}_resolution_{res}"] = (
                    (time.perf_counter() - t0) * 1e3 / (reps * len(infos)))
    if ok:
        for a, b in zip(got["native"][1], got["pil"][1]):
            for f in ("image", "alpha_mask"):
                _require(_within_ulp(getattr(a, f).cpu().numpy(),
                                     getattr(b, f).cpu().numpy()),
                         f"native: {f} of view {a.uid} at resolution 1 is "
                         f"not within an ulp of PIL's")
        jobs = [(i.image_path, c.width, c.height)
                for i, c in zip(infos, got["native"][2])]
        with native.ImagePool() as pool:
            pooled = pool.load_many(jobs)
        for (path, w, h), c, p in zip(jobs, got["native"][2], pooled):
            want = native.load_image_rgba(path, w, h)
            _require(np.array_equal(p, want),
                     f"native: pool != load of {path}")
            _require(np.array_equal(c.image.cpu().numpy(), want[..., :3])
                     and np.array_equal(c.alpha_mask.cpu().numpy(),
                                        want[..., 3:4]),
                     f"native: camera of {path} at resolution 2 differs "
                     f"from load_image_rgba")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_colmap_"))
    try:
        path = str(work / "points3D.bin")
        _write_points3d(path, n_points)
        rep["points3d_points"] = n_points
        rep["points3d_mb"] = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        walk = colmap._read_points3D_binary_walk(path)
        rep["points3d_walk_s"] = time.perf_counter() - t0
        _require(walk[0].shape[0] == n_points, "points3D: the walk's count")
        if ok:
            t0 = time.perf_counter()
            parsed = colmap.read_points3D_binary_full(path)
            rep["points3d_native_s"] = time.perf_counter() - t0
            _require(all(a.dtype == b.dtype and np.array_equal(a, b)
                         for a, b in zip(parsed, walk)),
                     "native: the points3D parse differs from the walk")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    line = "; ".join(
        f"{name}: camera_list {rep[f'camera_list_s_{name}']:.3f} s for "
        f"{len(infos)} views, "
        f"{rep[f'ms_per_image_{name}_resolution_1']:.3f} / "
        f"{rep[f'ms_per_image_{name}_resolution_2']:.3f} ms an image at "
        f"resolution 1 / 2" for name in loaders)
    line += (f"; points3D {n_points} points ({rep['points3d_mb']:.1f} MB): "
             f"walk {rep['points3d_walk_s']:.3f} s")
    if ok:
        line = (f"native: built in {rep['build_s']:.2f} s; resolution 1 "
                f"within an ulp of PIL, resolution 2 bit for bit "
                f"load_image_rgba and the pool; " + line
                + f", native {rep['points3d_native_s']:.3f} s "
                f"({rep['points3d_walk_s'] / rep['points3d_native_s']:.1f}x)")
    else:
        line = "native: unavailable, PIL and the walk only; " + line
    print(line, flush=True)
    return rep


def _calibrated_exchange(rep13):
    """Phase 14b: the 1x2 band cases of phase 13's gloo launch, whose
    `tools/mesh_check` now calibrates instance_cap and band_cap as the
    trainer does (held there: gradients within 2e-4 x max, nothing
    dropped): the capacities, the bytes exchanged a step, p50 a rank."""
    out = {}
    for name in ("1x2", "1x2:2D"):
        per = rep13["world2"]["cases"][name]["per_rank"]
        caps = {(x["instance_cap"], x["band_cap"]) for x in per}
        _require(len(caps) == 1, f"mesh {name}: capacities {caps}")
        cap, band_cap = caps.pop()
        _require(band_cap is not None, f"mesh {name}: no band_cap")
        out[name] = {"instance_cap": cap, "band_cap": band_cap,
                     "exchange_mb_per_step":
                         per[0]["exchange"]["bytes_per_step"] / 1e6,
                     "step_ms_p50": [x["step_ms_p50"] for x in per]}
        print(f"mesh_check calibrated: {name} band_cap {band_cap}, "
              f"instance_cap {cap}, exchange "
              f"{out[name]['exchange_mb_per_step']:.2f} MB a step, p50 "
              + " / ".join(f"{x:.2f}" for x in out[name]["step_ms_p50"])
              + " ms a rank", flush=True)
    return out


def _band_overhead(root, work):
    """Phase 14c: `tools/profile_band_overhead` at the 1080p flagship, 1x1
    (one NCCL rank through `torch.distributed.run`): its table's top rows;
    the rows must sum to the busy difference within 5% and K1 and K2
    launch once a step in each step."""
    out = work / "band_profile.json"
    logs = _spawn([[sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", "1", "-m",
                    "horizongs_tpu_torch.tools.profile_band_overhead",
                    "--out", str(out)]],
                  dict(os.environ, PYTHONPATH=str(root)), 600)
    with open(out) as f:
        rec = json.load(f)
    lines = logs[0].splitlines()
    first = next(i for i, x in enumerate(lines)
                 if x.startswith("1x1 band step"))
    for line in lines[first:first + 12]:
        print(f"band overhead: {line}", flush=True)
    _require(rec["backend"] == "nccl", f"band overhead on {rec['backend']}")
    _require(rec["rows_match_total"],
             f"band overhead: rows sum {rec['rows_sum_ms']} ms against the "
             f"busy difference {rec['total_diff_ms']} ms")
    for k in ("plain", "band"):
        _require(rec[k]["launches_per_step"] == {"K1": 1.0, "K2": 1.0},
                 f"band overhead {k}: launches {rec[k]['launches_per_step']}")
        n = rec[k]["steps_run"]
        _require(rec[k]["launches"] == {"K1": n, "K2": n},
                 f"band overhead {k}: {rec[k]['launches']} launches in "
                 f"{n} steps")
    _require(rec["launches_process"] == {
        x: rec["launches_setup"][x] + rec["plain"]["launches"][x]
        + rec["band"]["launches"][x] for x in ("K1", "K2")},
        f"band overhead: the process launched {rec['launches_process']}, "
        f"not its set-up's {rec['launches_setup']} and its steps'")
    rec["rows_k1_k2"] = [r for r in rec["rows"] if "raster3d" in r["name"]]
    rec["rows"] = rec["rows"][:20]
    return rec


def _convergence(work, its=400):
    """Phase 14d: `tools/convergence_check` on quickstart for `its`
    iterations, single device then `--mesh 1x2` (two gloo ranks on the
    card): both PSNRs finite, the same densify epochs, K1 and K2 once an
    iteration on every rank. The last iteration's kernel arguments are
    captured in each run (each rank's band) for `_captured_vs_plain`."""
    from horizongs_tpu_torch.tools import convergence_check
    out = work / "convergence.json"
    convergence_check.main(["--iterations", str(its), "--workdir",
                            str(work / "conv"), "--out", str(out)])
    with open(out) as f:
        rec = json.load(f)
    s, m = rec["single"], rec["mesh_1x2"]
    _require(math.isfinite(s["test_psnr"]) and math.isfinite(m["test_psnr"]),
             f"convergence: PSNR {s['test_psnr']}, {m['test_psnr']}")
    _require(rec["densify_epochs"]["single"] == rec["densify_epochs"]["mesh"]
             and rec["densify_epochs"]["single"] >= 1,
             f"convergence: densify epochs {rec['densify_epochs']}")
    _require(rec["launches_once_per_iteration"],
             "convergence: K1/K2 launches "
             + str([r["launches"] for r in s["ranks"] + m["ranks"]]))
    return rec


def _captured_vs_plain(rec, dev):
    """K1 and K2 against their plain versions on the arguments of
    convergence's captured steps (the single run's 64x64 view, each 1x2
    rank's band with its halo), at phases 4/5's tolerances."""
    out = {}
    for run, paths in rec["captures"].items():
        for r, path in enumerate(paths):
            ok, errs = _band_kernels_vs_plain(path, dev)
            _require(ok, f"convergence {run} rank {r}: a kernel disagrees "
                     f"with its plain version on its step's inputs: {errs}")
            out[f"{run}_rank{r}"] = errs
            print(f"convergence {run} rank {r}: K1/K2 on iteration "
                  f"{rec['iterations']}'s inputs ({errs['shape']}) within "
                  f"tolerance of the plain versions: K1 acc "
                  f"{errs['fwd']['acc_rgb_alpha']:.3g}, K2 "
                  f"{errs['bwd']['max_abs_err']:.3g}", flush=True)
    return out


def _densify_bench(work):
    """Phase 14e: `tools/bench_densify` at 1M anchors x 10 offsets on the
    card: the JAX tool's epoch, and a growth epoch that adds rows; the npz
    and sharded round trips bit for bit."""
    from horizongs_tpu_torch.tools import bench_densify
    out = work / "densify_bench.json"
    rc = bench_densify.main(["--out", str(out)])
    with open(out) as f:
        rec = json.load(f)
    _require(rc == 0 and all(rec["round_trip_exact"].values()),
             f"densify bench: round trip {rec['round_trip_exact']}")
    g = rec["grow_epoch"]
    _require(g is not None and g["added"] > 0
             and g["anchors_after_densify"]
             == rec["anchors"] + g["added"] - g["pruned"],
             f"densify bench: the growth epoch {g}")
    return rec


# ---------------------------------------------------------------------------
# phase 15: the mesh's scaling tool (tools/bench_scaling.py)
# ---------------------------------------------------------------------------

def _parts(row):
    """A sweep row's configurations: the band step, and its pure-DP
    control where the row has one."""
    return [("band", row)] + ([("pure_dp", row["pure_dp"])]
                              if "pure_dp" in row else [])


def _band_crop_vs_plain(bt, work, dev):
    """K1 and K2 against their plain versions on the arguments of one
    cropped step of `--band_times`: the tallest band of n_model 8
    (balanced bounds; of equals the lowest) on view 0, the principal
    point moved up by the band's first row, at the record's capacity."""
    import torch
    from horizongs_tpu_torch.data.synthetic import orbit_cameras
    from horizongs_tpu_torch.ops.raster_fields import backend_tile_shape
    from horizongs_tpu_torch.tools import bench_scaling
    from horizongs_tpu_torch.tools.mesh_check import _Capture, _kernels
    from horizongs_tpu_torch.train.step import build_train_step, camera_tensors
    W, H = bt["width"], bt["height"]
    _, tile_h = backend_tile_shape("3D")
    ent = bt["bands"]["8"]["balanced"]
    # the tallest band, the lowest of equals: a principal point moved up
    b = max(range(8), key=lambda i: (ent["rows"][i], i))
    y0 = ent["bounds"][b] * tile_h
    h = min(ent["rows"][b] * tile_h, H - y0)
    _require(y0 > 0 and h > 0, f"scaling: band {b} of {ent['bounds']}")
    cfg, ts, _ = bench_scaling._scene(W, H, bt["n_points"], bt["capacity"],
                                      1, 1, dev)
    cam = orbit_cameras(bt["views"], radius=2.0, height_z=-0.15, width=W,
                        height=H, device=dev)[0]
    step = build_train_step(cfg, bench_scaling._zero_lr_optim(), h, W,
                            add_prefilter=False,
                            instance_cap=ent["instance_cap"])
    _, names = _kernels("3D")
    with _Capture(names) as cap:
        _, m = step(ts, camera_tensors(bench_scaling._crop_camera(cam, y0, h),
                                       do_stats=True), 1)
        float(m["loss"])
    path = work / "capture_band_crop.pt"
    torch.save({"gs": "3D", "fwd": cap.calls[names[0]][0],
                "bwd": cap.calls[names[1]][0]}, path)
    ok, errs = _band_kernels_vs_plain(path, dev)
    _require(ok, f"scaling: a kernel disagrees with its plain version on "
             f"the band crop's inputs: {errs}")
    errs.update(band=b, y0_px=y0, height_px=h, dropped=int(m["n_dropped"]))
    return errs


def _scaling(kernels, dev, n_cards):
    """Phase 15: `tools/bench_scaling` through its command line, each mode
    with the counts set to 0 just before it and read just after (the
    sweep's ranks count their own, from their process's start): a. the
    sweep `--devices 1,2` at 512x512 (two gloo ranks on one card: the 1x2
    band step and its 2x1 pure-DP control; `1,2,4` over NCCL with four
    cards); b. `--tpu_overhead` at 1920x1088; c. `--band_times` at
    1920x1088 (6 views); d. `--project 4` and `--project 8` on b's and
    c's records; e. `--imbalance` at 512x512. K1 and K2 once a step a
    rank in a-c, no kernel in d-e, nothing dropped after the tool's
    re-runs, the count guard held; then K1 and K2 against their plain
    versions on a band crop of c. Returns the report and the K1-K4
    launches of a-c."""
    import shutil
    import tempfile
    from horizongs_tpu_torch.tools import bench_scaling
    n_k = len(kernels)
    zero = (0,) * n_k
    launches = [0] * n_k
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_scaling_"))
    out = work / "scaling.json"
    rep, secs = {}, {}

    def run(name, *argv):
        _reset(kernels)
        t0 = time.perf_counter()
        rc = bench_scaling.main([*argv, "--out", str(out)])
        secs[name] = time.perf_counter() - t0
        _require(rc == 0, f"scaling {name}: rc {rc}")
        with open(out) as f:
            return json.load(f), _counts(kernels)

    try:
        # a. the sweep
        devices = "1,2,4" if n_cards >= 4 else "1,2"
        rec, here = run("sweep", "--devices", devices, "--iters", "10")
        _require(here == zero, f"scaling sweep: this process launched {here}")
        rows = rec["results"]
        _require([r["devices"] for r in rows]
                 == [int(x) for x in devices.split(",")],
                 f"scaling sweep: rows {[r['devices'] for r in rows]}")
        _require(all("pure_dp" in r for r in rows[1:]),
                 "scaling sweep: a row without its pure-DP control")
        _require(rec["shared_card"] == (n_cards < 2),
                 f"scaling sweep: shared_card {rec['shared_card']} on "
                 f"{n_cards} card(s)")
        for r in rows:
            for name, p in _parts(r):
                _require(p["n_dropped"] == 0, f"scaling sweep {r['devices']}"
                         f" {name}: dropped {p['n_dropped']} at margin "
                         f"{p['margin']}")
                for k, n in zip(p["launches_per_rank"],
                                p["steps_run_per_rank"]):
                    _require(k == [n, n], f"scaling sweep {r['devices']} "
                             f"{name}: a rank launched {k} in {n} steps")
                    launches[0] += k[0]
                    launches[1] += k[1]
        rep["sweep"] = rec
        for r in rows:
            print(f"scaling: sweep {r['devices']} rank(s), mesh {r['mesh']} "
                  f"({r['backend']}) p50 {r['step_ms']:.2f} ms ("
                  + " / ".join(f"{x:.2f}" for x in r["step_ms_p50_per_rank"])
                  + f"), {r['rays_per_sec']:,.0f} rays/s, instance_cap "
                  f"{r['instance_cap']}, band_cap {r['band_cap']}"
                  + (f"; pure-DP {r['pure_dp']['mesh']} p50 "
                     f"{r['pure_dp']['step_ms']:.2f} ms, band/DP "
                     f"{r['efficiency_vs_pure_dp']:.3f}" if "pure_dp" in r
                     else "")
                  + f"; efficiency {r['efficiency']:.3f}", flush=True)

        # b. the 1x1 band overhead
        rec, here = run("overhead", "--tpu_overhead")
        o = rec["card_1x1_overhead"]
        for k in ("plain", "band"):
            n = o["steps_run"][k]
            _require(o["launches"][k] == [n, n] and o["n_dropped"][k] == 0,
                     f"scaling overhead {k}: launched {o['launches'][k]} in "
                     f"{n} steps, dropped {o['n_dropped'][k]}")
        _require(list(here[:2]) == [sum(o["launches"][k][i]
                                         for k in ("plain", "band"))
                                     for i in (0, 1)] and here[2:] == zero[2:],
                 f"scaling overhead: this process launched {here}")
        _require(math.isfinite(o["band_overhead_ratio"]),
                 f"scaling overhead: ratio {o['band_overhead_ratio']}")
        launches[0] += here[0]
        launches[1] += here[1]
        rep["overhead"] = o
        print(f"scaling: 1x1 overhead at {o['width']}x{o['height']}: plain "
              f"{o['plain_step_ms']:.2f} ms, band {o['band_step_ms']:.2f} ms"
              f", ratio {o['band_overhead_ratio']:.4f} (rounds plain "
              f"{[round(x, 2) for x in o['rounds_ms']['plain']]}, band "
              f"{[round(x, 2) for x in o['rounds_ms']['band']]})",
              flush=True)

        # c. the per-band step times
        rec, here = run("band_times", "--band_times")
        bt = rec["band_time_skew"]
        n = bt["steps_run"]
        _require(bt["launches"] == [n, n] and list(here[:2]) == [n, n]
                 and here[2:] == zero[2:],
                 f"scaling band times: launched {bt['launches']} ({here}) "
                 f"in {n} steps")
        _require(bt["n_dropped"] == 0, f"scaling band times: dropped "
                 f"{bt['n_dropped']} after {bt['reruns']} re-runs")
        g = bt["count_guard"]
        _require(0.9 <= g["ratio"] <= 1.1, f"scaling count guard {g}")
        launches[0] += n
        launches[1] += n
        rep["band_times"] = bt
        fit = bt["fit"]
        print(f"scaling: band times at {bt['width']}x{bt['height']}, "
              f"{bt['views']} views, {n} steps: count guard {g['analytic']} "
              f"/ {g['production']} ({g['ratio']:.4f}); whole views "
              f"{bt['per_view_1080p']['step_ms']} ms (worst/mean "
              f"{bt['per_view_1080p']['time_worst_over_mean']:.3f}); fit "
              f"t = {fit['c0_ms']} + {fit['c_row_ms_per_tile_row']} x rows "
              f"+ {fit['c_rec_ms_per_record'] * 1e3:.5f} x krecords ms (rms "
              f"{fit['rms_ms']}, load share {fit['load_fraction_f']}); "
              "worst/mean " + ", ".join(
                  f"{m} {v} {e[v]['time_worst_over_mean_max']:.3f}"
                  for m, e in bt["bands"].items()
                  for v in ("uniform", "balanced")),
              flush=True)
        _reset(kernels)
        rep["band_crop_vs_plain"] = errs = _band_crop_vs_plain(bt, work, dev)
        print(f"scaling: K1/K2 on the tallest n_model=8 band of view 0 "
              f"(rows {errs['y0_px']}-{errs['y0_px'] + errs['height_px']}, "
              f"{errs['shape']}) within tolerance of the plain versions: "
              f"K1 acc {errs['fwd']['acc_rgb_alpha']:.3g}, K2 "
              f"{errs['bwd']['max_abs_err']:.3g}", flush=True)

        # d. the projection and e. the imbalance: counts only
        for n_p in (4, 8):
            rec, here = run(f"project{n_p}", "--project", str(n_p))
            _require(here == zero, f"scaling project {n_p}: launched {here}")
            pr = rep[f"project{n_p}"] = rec[f"projected_efficiency_{n_p}card"]
            print(f"scaling: projected {n_p} cards (NVLink "
                  f"{pr['basis']['link_bw_bytes_per_s_one_way'] / 1e9:.0f} "
                  f"GB/s each way): " + ", ".join(
                      f"{r['mesh']} {r['projected_efficiency']:.3f} (t_comm "
                      f"{r['t_comm_ms']:.4f} ms)" for r in pr["meshes"]),
                  flush=True)
        rec, here = run("imbalance", "--imbalance")
        _require(here == zero, f"scaling imbalance: launched {here}")
        im = rep["imbalance"] = rec["load_imbalance"]
        print(f"scaling: imbalance at {im['width']}x{im['height']}: views "
              f"worst/mean {im['dp_view_imbalance']['worst_over_mean']:.3f}; "
              "bands uniform -> balanced " + ", ".join(
                  f"{m}: {e['worst_over_mean_max']:.3f} -> "
                  f"{e['balanced_worst_over_mean_max']:.3f}"
                  for m, e in im["band_imbalance"].items()), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rep["seconds_by_mode"] = secs
    return rep, tuple(launches)


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
        grid_overhead, project3d, raster2d, raster3d, raster_cuda)
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
    P1 = (project3d.KERNEL, project3d.KERNEL_BWD)   # counted in phases 4-7

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
                "T3": T3["empty"], "P1": project3d.KERNEL}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(to_build)) as pool:
        built = dict(zip(to_build, pool.map(lambda k: k.build(),
                                            to_build.values())))
    print(f"build K1-K4, T1-T3, P1: {time.perf_counter() - t0:.2f} s")
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
                raster3d.rasterize_fwd, (*ALL, *P1),
                (n_views, 0, 0, 0, *NO_TOOLS, n_views, 0))
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
                 build_raster_inputs_2dgs, raster2d.rasterize2d_fwd,
                 (*ALL, *P1), (0, 0, n_views_2d, 0, *NO_TOOLS, 0, 0))
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
                "rasterize_bwd", (*ALL, *P1), (1, 1, 0, 0, *NO_TOOLS, 1, 1))
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
                 "rasterize2d_bwd", (*ALL, *P1),
                 (0, 0, 1, 1, *NO_TOOLS, 0, 0))
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

    # 8b. P1 against the plain path at 10M rows, then timed ----------------
    from horizongs_tpu_torch.tools.profile_project import (
        profile_project, within_twice_plain)
    p1 = profile_project(device=dev)
    print(f"P1 {p1['rows']} rows: {json.dumps(p1)}")
    _require(not any(n for n, _ in p1["forward_rows_off"].values()),
             "P1's forward differs from the plain path")
    _require(within_twice_plain({"all": p1["backward_errors"]}),
             "P1's backward is further from float64 than twice the plain "
             "path")

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

    # 10. the train CLI on the flagship512 config, 11. the serving and
    # export CLIs on the model directories it writes and 12. the chunk
    # pipeline on its dataset ---------------------------------------------
    t11, t12, t13, t14 = [], [], [], []

    def serve_cli_and_chunks(coarse, surfel, info):
        t0 = time.perf_counter()
        out11 = _serve_cli(coarse, surfel, info, ALL, dev)
        t11.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out12 = _chunks(root, info, ALL, dev)
        t12.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out13 = _mesh_cli(root, info, ALL, dev)
        t13.append(time.perf_counter() - t0)
        # 14a. the native loader on this dataset (no kernel)
        t0 = time.perf_counter()
        out14 = _native_loader(info, dev)
        t14.append(time.perf_counter() - t0)
        return out11, out12, out13, out14

    t_cli = time.perf_counter()
    cli10, ((rep11, launches11), (rep12, launches12),
            (rep13_cli, launches13_cli), rep14_native) = _train_cli(
        root, ALL, dev, then=serve_cli_and_chunks)
    cli10["seconds"] = (time.perf_counter() - t_cli - t11[0] - t12[0]
                        - t13[0] - t14[0])
    c10 = cli10["coarse"]
    print(f"train CLI: {c10['iterations']} coarse iterations at "
          f"{c10['iterations_per_s']:.2f} it/s (p50 "
          f"{c10['iteration_ms_p50']:.2f} ms, host outside step p50 "
          f"{c10['host_ms_outside_step_p50']:.3f} ms), test PSNR "
          f"{c10['test_psnr']:.3f}; window busy "
          f"{cli10['window']['device_busy_ms_per_iteration']:.3f} ms/it, "
          f"idle {cli10['window']['device_idle_share']:.3f}; "
          f"{cli10['seconds']:.1f} s", flush=True)
    v11, m11 = rep11["viewer"], rep11["mesh_export"]
    print(f"serve CLI: render CLI {rep11['render_cli']['view_ms_p50']:.2f} "
          f"ms/view; viewer 1080p p50 {v11['wall_ms_p50_1080p']:.2f} ms "
          f"(busy {v11['device_busy_ms_p50']:.3f}); explicit "
          f"{rep11['explicit']['baked_gaussians']} baked in "
          f"{rep11['explicit']['bake_ms']:.1f} ms; LPIPS "
          f"{rep11['metrics']['lpips_ms_per_512_pair']:.3f} ms/pair; TSDF "
          f"fuse {m11['fuse_ms']:.1f} ms (CPU copy "
          f"{m11['fuse_cpu_copy_ms']:.1f}); {t11[0]:.1f} s", flush=True)
    m12 = rep12["merge"]
    print(f"chunks: {len(rep12['partition']['chunks'])} chunks, "
          f"{len(rep12['train']['jobs'])} jobs in "
          f"{rep12['train']['seconds']:.1f} s ("
          + ", ".join(f"{j['iterations_per_s']:.2f}"
                      for j in rep12["train"]["jobs"])
          + f" it/s), merge {m12['rows_merged']} rows, merged PSNR "
          f"{m12['test_psnr']:.3f}; {t12[0]:.1f} s", flush=True)

    # 13. the mesh: the sharded step at 1x1 (NCCL), 1x2 and 2x1 (gloo, two
    # ranks on this card); the train CLI's run above ----------------------
    t0 = time.perf_counter()
    rep13, launches13 = _mesh_steps(root, ALL, dev)
    t13.append(time.perf_counter() - t0)
    launches13 = tuple(a + b for a, b in zip(launches13, launches13_cli))
    print(f"mesh: {t13[0] + t13[1]:.1f} s (train CLI {t13[0]:.1f} s, "
          f"steps {t13[1]:.1f} s)", flush=True)

    # 14. the rest: the native loader (14a, above), mesh_check's
    # calibrated exchange (14b, phase 13's launch), the band overhead
    # (14c), convergence (14d) and the city-scale densify (14e) --------
    import shutil
    import tempfile
    work14 = Path(tempfile.mkdtemp(prefix="chip_smoke_rest_"))
    t0 = time.perf_counter()
    try:
        rep14_mesh = _calibrated_exchange(rep13)
        _reset(ALL)
        rep14_band = _band_overhead(root, work14)
        rep14_conv = _convergence(work14)
        rep14_dens = _densify_bench(work14)
        launches14_here = _counts(ALL)
        rep14_conv["kernels_vs_plain"] = _captured_vs_plain(rep14_conv, dev)
    finally:
        shutil.rmtree(work14, ignore_errors=True)
    t14.append(time.perf_counter() - t0)
    _require(launches14_here[2:] == (0, 0, *NO_TOOLS),
             f"phase 14 launched {launches14_here}")
    # this process ran convergence's single-device run; the others ran in
    # the processes the tools launched, each counting from its start
    conv_s, conv_m = rep14_conv["single"], rep14_conv["mesh_1x2"]
    launches14 = tuple(
        launches14_here[i]
        + sum(r["launches_process"][i] for r in conv_m["ranks"])
        + rep14_band["launches_process"][("K1", "K2")[i]]
        for i in (0, 1)) + (0, 0, *NO_TOOLS)
    print(f"convergence: quickstart {rep14_conv['iterations']} iterations, "
          f"test PSNR single {conv_s['test_psnr']:.3f} / --mesh 1x2 "
          f"{conv_m['test_psnr']:.3f} (gap {rep14_conv['psnr_gap_db']:.4f} "
          f"dB), anchors {rep14_conv['anchors_final']['single']} / "
          f"{rep14_conv['anchors_final']['mesh']}, densify epochs "
          f"{rep14_conv['densify_epochs']['single']} / "
          f"{rep14_conv['densify_epochs']['mesh']}; "
          f"{conv_s['seconds']:.1f} / {conv_m['seconds']:.1f} s", flush=True)
    d = rep14_dens
    print(f"densify bench: {d['anchors']} anchors x {d['n_offsets']} "
          f"(capacity {d['capacity']}; params {d['device_mb']['params']:.0f}"
          f" MB, moments {d['device_mb']['adam_moments']:.0f} MB, stats "
          f"{d['device_mb']['stats']:.0f} MB): build {d['build_s']:.2f} s, "
          f"densify epoch {d['densify_epoch_s']:.3f} s "
          f"({json.dumps(d['densify_phases_ms'])}; +{d['added']} "
          f"-{d['pruned']}), npz save {d['checkpoint_save_s']:.2f} s / load "
          f"{d['checkpoint_load_s']:.2f} s ({d['checkpoint_mb']:.1f} MB), "
          f"sharded 1x1 save {d['sharded_save_s']:.2f} s / load "
          f"{d['sharded_load_s']:.2f} s ({d['sharded_mb']:.1f} MB), round "
          f"trips bit for bit", flush=True)
    g = d["grow_epoch"]
    print(f"densify bench, growth epoch ({g['share']} of the observed "
          f"offsets past the threshold, {g['candidates']} candidates): "
          f"{g['densify_epoch_s']:.3f} s ({json.dumps(g['densify_phases_ms'])}"
          f"; +{g['added']} -{g['pruned']}, {g['anchors_after_densify']} "
          f"anchors, capacity {g['capacity_after_densify']})", flush=True)
    print(f"rest: {t14[0] + t14[1]:.1f} s (native {t14[0]:.1f} s)",
          flush=True)

    # 15. the mesh's scaling tool: the sweep, the 1x1 overhead, the band
    # times, the projections and the imbalance ---------------------------
    t0 = time.perf_counter()
    rep15, launches15 = _scaling(ALL, dev, torch.cuda.device_count())
    t15 = time.perf_counter() - t0
    launches15 = launches15[:2] + (0, 0, *NO_TOOLS)
    print(f"scaling: {t15:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in rep15["seconds_by_mode"].items())
        + " s)", flush=True)

    # 16. report -------------------------------------------------------------
    paths = {"serve_3dgs": sv["launches"], "train_3dgs": tr["launches"],
             "serve_2dgs": sv2["launches"], "train_2dgs": tr2["launches"],
             "train_cli": cli10["launches"], "serve_cli": launches11,
             "chunks": launches12, "mesh": launches13, "rest": launches14,
             "scaling": launches15}

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
    print(json.dumps({
        "slice": "train CLI flagship512 (configs/synthetic/flagship512.yaml)"
                 ", coarse -> resume -> fine, 2DGS (cuda)", "card": card,
        "step_busy_ms_1080p_phase6":
            _profile_report(tr["prof"])["device_busy_ms"],
        **{k: v for k, v in cli10.items() if k != "launches"}}))
    print(json.dumps({
        "slice": "serve CLI flagship512: render CLI, metrics, viewer, "
                 "explicit bake, mesh export (cuda)", "card": card,
        "seconds": t11[0],
        "launches": dict(zip(("K1", "K2", "K3", "K4"), launches11[:4])),
        **rep11}))
    print(json.dumps({
        "slice": "chunks flagship512 (configs/synthetic/chunks512.yaml): "
                 "partition 2x1 -> coarse + fine per chunk -> merge -> "
                 "evaluation (cuda)", "card": card, "seconds": t12[0],
        "launches": dict(zip(("K1", "K2", "K3", "K4"), launches12[:4])),
        **rep12}))
    print(json.dumps({
        "slice": "mesh: flagship 1920x1088 step at 1x1 (nccl), 1x2 and 2x1 "
                 "(gloo, two ranks on one card); train CLI flagship512 "
                 "--mesh 1x2 (gloo) -> resume --mesh 1x1 (nccl) (cuda)",
        "card": card, "seconds": t13[0] + t13[1],
        "launches": dict(zip(("K1", "K2", "K3", "K4"), launches13[:4])),
        "steps": rep13, "train_cli": rep13_cli}))
    print(json.dumps({
        "slice": "rest: native loader on flagship512's dataset, mesh_check "
                 "calibrated (1x2, gloo), band overhead 1920x1088 1x1 "
                 "(nccl), convergence quickstart single vs --mesh 1x2, "
                 "densify and checkpoints at 1M anchors (cuda)",
        "card": card, "seconds": t14[0] + t14[1],
        "launches": dict(zip(("K1", "K2", "K3", "K4"), launches14[:4])),
        "native": rep14_native, "mesh_check_calibrated": rep14_mesh,
        "band_overhead": rep14_band, "convergence": rep14_conv,
        "densify_bench": rep14_dens}))
    print(json.dumps({
        "slice": "scaling: tools/bench_scaling sweep 512x512 (1x1 nccl, 1x2 "
                 "and 2x1 gloo on one card), 1x1 overhead, band times, "
                 "projections at 4 and 8 cards, imbalance (cuda)",
        "card": card, "seconds": t15,
        "launches": dict(zip(("K1", "K2", "K3", "K4"), launches15[:4])),
        **rep15}))
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
        "library_ms": ({"write": t3_2040["zero_"]["launch_us"] / 1e3,
                        "one_copy": t3_2040["copy_"]["launch_us"] / 1e3}
                       .get(k)),
        "card": card} for j, k in enumerate(("empty", "write", "one_copy"))]
    n_all = len(ALL)
    p1_paths = {p: paths[p] for p in ("serve_3dgs", "train_3dgs",
                                      "serve_2dgs", "train_2dgs")}
    p1_entries = [{
        "name": f"project3d_{d} (P1)", "route": "cuda",
        "source": "horizongs_tpu_torch/csrc/project3d.cu",
        # no Pallas counterpart: the JAX package projects in plain jnp
        "replaces": "horizongs_tpu_torch/ops/projection.py project_3dgs",
        "launches": sum(n[n_all + j] for n in p1_paths.values()),
        "launches_by_path": {p: n[n_all + j] for p, n in p1_paths.items()},
        "max_abs_err": (max(big for _, big in p1["forward_rows_off"]
                            .values()) if d == "fwd" else
                        max(e[2] for e in p1["backward_errors"].values())),
        "errors": (p1["forward_rows_off"] if d == "fwd"
                   else p1["backward_errors"]),
        "tolerance": ("bit for bit the plain path's fields, radii and cull "
                      "radii" if d == "fwd" else
                      "per leaf, error against float64 at most twice the "
                      "plain float32 path's"),
        "ms": p1[f"{d}_ms"], "plain_ms": p1[f"plain_{d}_ms"],
        "bound_ms": p1[f"bound_{d}_ms"], "bound_by": "bytes",
        "bound_share": p1[f"{d}_pct"] / 100.0, "library_ms": None,
        **(_ptxas(built["P1"].log, f"project3d_{d}_kernel") or {}),
        "rows": p1["rows"], "card": card}
        for j, d in enumerate(("fwd", "bwd"))]
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
        *t2_entries, *t3_entries, *p1_entries]}))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-cli"]:
        sys.exit(_mesh_cli_worker(*sys.argv[2:]))
    sys.exit(main())
