"""T2's tool: K2's time split among its parts, from stripped variants.

    python -m horizongs_tpu_torch.tools.profile_bwd_variants [--device cuda]

The port of `tools/profile_bwd_variants.py`. Its scene: 100k
`random_gaussians(seed=0, extent=1.5, scale_range=(0.004, 0.02))` seen
from (0, 0, -4) at 1920x1088, instance cap 6n, through the port's
`build_raster_inputs` and K1, with d_acc = 1 and d_logT = 0. The variants
of `ops/raster3d.py::rasterize_bwd_variant` run on K1's records, each
timed with CUDA events (best of 3 x 20): full (K2), no_atomic (gradients
formed, not added), no_color (dL/dw from the alpha row only, no colour or
depth sums), no_reduce (no ballot, reduce-scatter or shared
accumulator, so no per-gaussian sums and no atomics) and walk_only (the
walk with its skip tests, alpha and the log T walk). Each
variant runs at K2's blocks per SM (its launch reserves the shared memory
that holds it there; the tool prints both). Each variant's difference
from full is then the time of what it leaves out: full - no_atomic the
atomics, no_atomic - no_reduce the block reduction, no_reduce - walk_only
the gradient math per pair, walk_only the walk. It needs a card.
"""
from __future__ import annotations

import argparse
import json

import torch

from horizongs_tpu_torch.ops import raster3d
from horizongs_tpu_torch.ops.raster3d import G


def bwd_scene(n: int = 100_000, width: int = 1920, height: int = 1088,
              device=None):
    """The JAX tool's scene as K2's arguments (fields, gauss_id,
    tile_starts, d_acc, d_logT, logT, n_contrib, n_tiles_x, n_tiles_y) and
    its `RasterInputs`."""
    from horizongs_tpu_torch.data.synthetic import (
        lookat_camera, random_gaussians)
    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.ops.raster_cuda import build_raster_inputs
    dev = resolve_device(device)
    g = {k: torch.from_numpy(v).to(dev) for k, v in random_gaussians(
        n, seed=0, extent=1.5, scale_range=(0.004, 0.02)).items()}
    cam = lookat_camera(width=width, height=height, eye=(0, 0, -4),
                        device=dev)
    ri = build_raster_inputs(g["means"], g["quats"], g["scales"],
                             g["opacities"], g["colors"], cam.viewmat, cam.K,
                             width, height, cap=-(-6 * n // G) * G)
    ntx, nty = ri.grid.n_tiles_x, ri.grid.n_tiles_y
    acc, logT, n_contrib = raster3d.rasterize_fwd(
        ri.fields, ri.inst.gauss_id, ri.inst.tile_starts, ntx, nty)
    args = (ri.fields, ri.inst.gauss_id, ri.inst.tile_starts,
            torch.ones_like(acc), torch.zeros_like(logT[:, 0]),
            logT[:, 0].contiguous(), n_contrib, ntx, nty)
    return args, ri


def time_variants(args) -> dict:
    """ms of each variant on K2's arguments `args` (best of 3 x 20), each
    one's difference from full, and each one's blocks per SM and the
    shared memory (bytes) its blocks reserve to stay at K2's."""
    from horizongs_tpu_torch.tools.timing import best_ms
    ms = {v: best_ms(lambda: raster3d.rasterize_bwd_variant(v, *args))
          for v in raster3d.VARIANTS}
    occ = {v: raster3d.variant_occupancy(v, args[0].device.index)
           for v in raster3d.VARIANTS}
    return {"ms": ms, "minus_full_ms": {v: ms[v] - ms["full"] for v in ms},
            "blocks_per_sm": {v: b for v, (_, b) in occ.items()},
            "pad_bytes": {v: p for v, (p, _) in occ.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from horizongs_tpu_torch.tools.timing import require_cuda
    dev = require_cuda(a.device)
    args, ri = bwd_scene(device=dev)
    res = time_variants(args)
    for v in raster3d.VARIANTS:
        print(f"bwd[{v:10s}] {res['ms'][v]:8.4f} ms "
              f"({res['minus_full_ms'][v]:+8.4f} against full; "
              f"{res['blocks_per_sm'][v]} blocks/SM, "
              f"{res['pad_bytes'][v]} B reserved)")
    print(json.dumps({"tool": "profile_bwd_variants", "device": str(dev),
                      "instances": int(ri.inst.n_instances), **res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
