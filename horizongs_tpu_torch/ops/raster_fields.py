"""The field-level rasterization API: composite pre-projected splat records.

The JAX package's `ops/raster_fields.py`. The differentiable boundary of
the compositors is the packed per-gaussian field matrix ("records"):
projection, SH colour and the neural decode come before it; binning and
compositing after. The band-sharded step (`parallel/step.py`) sends records
across ranks by band (`parallel/tile_exchange.py`) and each rank composites
only its rows of the image, through the same kernels as a full view: K1/K2
for 3DGS and K3/K4 for 2DGS (`ops/raster_cuda.RasterCore` /
`RasterCore2D`; their plain versions for CPU tensors).

Field layouts (float32):
  3DGS (N, 10): [mx, my, conic_a, conic_b, conic_c, opacity, r, g, b, depth]
  2DGS (N, 18): [M1(3), M2(3), M3(3), mx, my, opacity, r, g, b, normal(3)]
    (+ a separate depth vector: the 2DGS depth is the per-pixel ray-splat
     intersection, so records carry depth only as the binning sort key)

Band shifting: a rank that owns image rows [dy, dy + band_px) composites
its band as an image of its own. For 3DGS that is my -= dy. For 2DGS the
ray-splat transform M maps (u, v, 1) to screen homogeneous coordinates with
hv = py·M3 - M2; substituting py = py_local + dy gives M2' = M2 - dy·M3
(and my' = my - dy for the low-pass term). The shifted fields are a fresh
contiguous tensor: the kernels stage `fields` with `cp.async` and refuse a
strided or unaligned one. The band step does not shift 2DGS records: it
passes the band's first row to K3 and K4 (`composite_fields_2dgs(row0=)`),
so each pixel is intersected at the view's coordinates (a shifted M2
rounds the intersection differently, and near edge-on surfels that moves
the gradients past the tolerance the step is held to).
"""
from __future__ import annotations

from typing import Optional

import torch

from horizongs_tpu_torch.ops import raster2d, raster3d
from horizongs_tpu_torch.ops.binning import build_tile_instances
from horizongs_tpu_torch.ops.project3d import project_fields_3dgs
from horizongs_tpu_torch.ops.projection import project_2dgs
from horizongs_tpu_torch.ops.raster import _make_grid, _tiles_to_image
from horizongs_tpu_torch.ops.raster_cuda import (
    GUARD_PX_2DGS,
    RasterCore,
    RasterCore2D,
    _assemble,
    _cap,
    _cull_radii,
)
from horizongs_tpu_torch.ops.reference import _sh_colors

def backend_tile_shape(gs_attr: str) -> tuple:
    """(tile_w, tile_h) of the kernels, the band granularity for sharding:
    32x32 for 3DGS (K1/K2), 32x16 for 2DGS (K3/K4)."""
    if gs_attr == "2D":
        return raster2d.TILE_W, raster2d.TILE_H
    return raster3d.TILE_W, raster3d.TILE_H


def _check_mode(render_mode: str) -> None:
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")


def pack_fields_3dgs(means, quats, scales, opacities, colors, viewmat, K,
                     width: int, height: int,
                     sh_degree: Optional[int] = None,
                     means2d_probe: Optional[torch.Tensor] = None):
    """Projection, SH colour and the lossless cull -> (fields (N, 10),
    radii (N,), proj): `ops/project3d.project_fields_3dgs`. `radii` is the
    cull radius of binning (0 where a gaussian never contributes);
    `proj.radii` stays the geometric radius the densification statistics
    read, and `proj`'s other fields are views of the field columns.
    `means2d_probe` is added to the projected means in the fields, as
    `ops/raster_cuda.build_raster_inputs` adds it."""
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    pf = project_fields_3dgs(
        means, quats, scales, opacities,
        lambda: _sh_colors(colors, sh_degree, means, cam_pos), viewmat, K,
        width, height, means2d_probe)
    return pf.fields, pf.cull, pf.proj


def pack_fields_2dgs(means, quats, scales, opacities, colors, viewmat, K,
                     width: int, height: int,
                     sh_degree: Optional[int] = None,
                     means2d_probe: Optional[torch.Tensor] = None):
    """-> (fields (N, 18), radii (N,), depths (N,), proj), with the cull
    radius guarded by the low-pass's 2.2 px."""
    proj = project_2dgs(means, quats, scales, viewmat, K, width, height)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_colors(colors, sh_degree, means, cam_pos)
    radii = _cull_radii(proj, opacities, GUARD_PX_2DGS)
    means2d = proj.means2d
    if means2d_probe is not None:
        means2d = means2d + means2d_probe
    M = proj.transforms
    fields = torch.cat([M[:, 0, :], M[:, 1, :], M[:, 2, :], means2d,
                        opacities[:, None], rgb, proj.normals],
                       dim=-1).contiguous()
    return fields, radii, proj.depths, proj


def shift_band_3dgs(fields: torch.Tensor, dy) -> torch.Tensor:
    """Records in image coordinates -> the band's (its rows start at dy),
    as a fresh contiguous tensor."""
    return torch.cat([fields[:, 0:1], fields[:, 1:2] - dy, fields[:, 2:]],
                     dim=-1).contiguous()


def shift_band_2dgs(fields: torch.Tensor, dy) -> torch.Tensor:
    """M2' = M2 - dy·M3 and my' = my - dy, as a fresh contiguous tensor."""
    return torch.cat([fields[:, 0:3], fields[:, 3:6] - dy * fields[:, 6:9],
                      fields[:, 6:10], fields[:, 10:11] - dy,
                      fields[:, 11:]], dim=-1).contiguous()


def composite_fields_3dgs(fields: torch.Tensor, radii: torch.Tensor,
                          width: int, height: int,
                          background: torch.Tensor,
                          render_mode: str = "RGB",
                          cap: Optional[int] = None):
    """Composite packed 3DGS records into an image of (height, width)
    through K1 (K2 in the backward): binning on the detached records, then
    `RasterCore`, then the image as `rasterize_cuda_3dgs` assembles it.
    height and width may be a band of a larger view: shift the records
    first (`shift_band_3dgs`). `cap` defaults to max(4N, G). Returns
    (render, alphas, info) with info's n_instances and n_dropped."""
    _check_mode(render_mode)
    grid = _make_grid(width, height, raster3d.TILE_W, raster3d.TILE_H)
    f = fields.detach()
    inst = build_tile_instances(
        f[:, 0:2], radii.detach(), f[:, 9], grid.n_tiles_x, grid.n_tiles_y,
        raster3d.TILE_W, raster3d.TILE_H, _cap(cap, fields.shape[0]),
        conics=f[:, 2:5], opacities=f[:, 5])
    acc, logT2, _ = RasterCore.apply(fields, inst.gauss_id,
                                     inst.tile_starts, grid.n_tiles_x,
                                     grid.n_tiles_y)
    render, alphas = _assemble(acc[:, 0:3], acc[:, 4:5], acc[:, 3:4],
                               logT2[:, 0:1], background, grid, width,
                               height, render_mode)
    return render, alphas, {"n_instances": inst.n_instances,
                            "n_dropped": inst.n_dropped}


def composite_fields_2dgs(fields: torch.Tensor, radii: torch.Tensor,
                          depths: torch.Tensor, width: int, height: int,
                          background: torch.Tensor,
                          render_mode: str = "RGB",
                          cap: Optional[int] = None, row0: int = 0):
    """Composite packed 2DGS records through K3 (K4 in the backward).
    Returns (render, alphas, normals, distort, median, info); the caller
    derives the normals from depth from the (band's) median depth.

    `row0`: the image rows are the view's rows [row0, row0 + height), the
    records in the view's coordinates. K3 and K4 then intersect each pixel
    at the view's coordinates, as the view's composite does (a multiple
    of the tile height keeps the view's tiles too); `shift_band_2dgs`
    gives the same band up to rounding, and the surfel intersection is ill
    conditioned enough near edge-on for that rounding to move gradients."""
    _check_mode(render_mode)
    grid = _make_grid(width, height, raster2d.TILE_W, raster2d.TILE_H)
    f = fields.detach()
    means2d = f[:, 9:11]
    if row0:
        means2d = torch.stack([f[:, 9], f[:, 10] - row0], dim=1)
    inst = build_tile_instances(
        means2d, radii.detach(), depths.detach(), grid.n_tiles_x,
        grid.n_tiles_y, raster2d.TILE_W, raster2d.TILE_H,
        _cap(cap, fields.shape[0]))
    acc, aux, _ = RasterCore2D.apply(fields, inst.gauss_id,
                                     inst.tile_starts, grid.n_tiles_x,
                                     grid.n_tiles_y, int(row0))
    render, alphas = _assemble(acc[:, 0:3], acc[:, 6:7], aux[:, 1:2],
                               aux[:, 0:1], background, grid, width, height,
                               render_mode)
    normals, distort, median = (
        _tiles_to_image(rows.transpose(1, 2), grid, height, width)
        for rows in (acc[:, 3:6], aux[:, 2:3], aux[:, 3:4]))
    return render, alphas, normals, distort, median, {
        "n_instances": inst.n_instances, "n_dropped": inst.n_dropped}
