"""CUDA-backed 3DGS and 2DGS rasterization, the counterpart of the JAX
package's `ops/raster_pallas.py`: SH colour and binning in PyTorch, the
per-tile compositing in hand-written kernels: K1 (forward) and K2
(backward) of `ops/raster3d.py` for 3DGS, K3 and K4 of `ops/raster2d.py`
for 2DGS (surfels). The 3DGS projection and the packing of its field row
are one step, `ops/project3d.project_fields_3dgs` (P1's kernel pair on
the card); the 2DGS projection is plain PyTorch.

The kernel boundary is the packed per-gaussian field matrix, (N, 10)
[mx, my, conic_a, conic_b, conic_c, opacity, r, g, b, depth] for 3DGS and
(N, 18) [M1, M2, M3, mx, my, opacity, r, g, b, normal] for 2DGS, wrapped in
a `torch.autograd.Function` (`RasterCore` / `RasterCore2D`, the JAX
package's `_raster_core` / `_raster2d_core` custom VJPs). Everything before
it (SH colour, the neural decode, the 2DGS projection) and after it
(background blend, depth modes, depth normals, losses) differentiates
with ordinary autograd, the 3DGS projection through P1's backward;
binning sees detached inputs, as the JAX wrapper's `stop_gradient`s make
it.

Gradient routing: K2 and K4 add each instance's gradient into its
gaussian's row of the field gradient themselves (atomics), so the JAX
package's routing fields and steps — `grad_slot`, `out_starts`, `inv_perm` and the
un-sort + cumsum of `_instance_grads_to_fields` — have no counterpart
here. Without a gradient (serving under `torch.no_grad()`, or no input
requiring one) autograd records no node, so nothing is kept for backward.

Spans (`horizongs_tpu_torch.tracing`, while its recorder is on):
`render.bin` around the projection, cull, tile spans, instance build and
sort (`build_raster_inputs*`), and inside it `render.project` around the
projection (with its counters `render.project_rows` and
`render.project_rows_card`, the rows P1 projected) and, for SH colours,
`render.sh` around their evaluation; `render.composite` around the
compositor and the assembly of the image; counters `render.instances`,
`render.instance_cap`, and for SH colours `render.sh_rows` and
`render.sh_coeffs`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.ops.binning import (
    TileInstances,
    build_tile_instances,
    count_tile_instances,
)
from horizongs_tpu_torch.ops import raster2d
from horizongs_tpu_torch.ops.project3d import (
    _cull_radii,
    project_fields_3dgs,
)
from horizongs_tpu_torch.ops.projection import (
    ProjectedGaussians,
    ProjectedSurfels,
    project_2dgs,
)
from horizongs_tpu_torch.ops.raster import _TileGrid, _make_grid, _tiles_to_image
from horizongs_tpu_torch.ops.raster2d import rasterize2d_bwd, rasterize2d_fwd
from horizongs_tpu_torch.ops.raster3d import (
    G,
    TILE_H,
    TILE_W,
    rasterize_bwd,
    rasterize_fwd,
)
from horizongs_tpu_torch.ops.reference import (
    _sh_colors,
    depth_to_normals,
)

# a 2DGS cull radius is never shrunk below the splat's geometric radius
# where that is under this many pixels (the screen-space low-pass reaches
# about 2.2 px)
GUARD_PX_2DGS = 2.2


def suggest_instance_cap(n_instances: int, margin: float = 1.25) -> int:
    """Round a measured instance count (times `margin`) up to a geometric
    capacity bucket (8 per octave, G-aligned), as the JAX package does."""
    b = 8
    need = max(int(math.ceil(n_instances * margin)), G)
    k = max(int(math.ceil(b * math.log2(need / G))), 0)
    cap = int(math.ceil(G * 2 ** (k / b)))
    return -(-cap // G) * G


def _cap(cap: Optional[int], n: int) -> int:
    """The instance capacity: max(4N, G) by default, rounded up to G."""
    cap = cap if cap is not None else max(4 * n, G)
    return -(-cap // G) * G


def count_instances_3dgs(means, quats, scales, opacities, viewmat, K,
                         width: int, height: int) -> torch.Tensor:
    """Instance count `rasterize_cuda_3dgs` enumerates for this view;
    feed the max over sample views to `suggest_instance_cap`."""
    grid = _make_grid(width, height, TILE_W, TILE_H)
    pf = project_fields_3dgs(means, quats, scales, opacities, None, viewmat,
                             K, width, height)
    return count_tile_instances(pf.fields[:, 0:2], pf.cull, grid.n_tiles_x,
                                grid.n_tiles_y, TILE_W, TILE_H,
                                conics=pf.fields[:, 2:5],
                                opacities=opacities)


def _sh_rgb(colors, sh_degree: Optional[int], means, cam_pos):
    """The fields' RGB: SH colours evaluated at `sh_degree` toward the
    camera (`_sh_colors`) inside the span `render.sh`, counting the rows
    evaluated (`render.sh_rows`) and the coefficients a row at that degree,
    (d+1)^2 (`render.sh_coeffs`); RGB colours pass through and record
    nothing."""
    if sh_degree is None:
        return colors
    with tracing.span("render.sh"):
        rgb = _sh_colors(colors, sh_degree, means, cam_pos)
    tracing.count("render.sh_rows", colors.shape[0])
    tracing.count("render.sh_coeffs", (sh_degree + 1) ** 2)
    return rgb


class RasterInputs(NamedTuple):
    """What K1 is launched on for one view, and what the wrapper needs
    around it."""
    proj: ProjectedGaussians
    fields: torch.Tensor      # (N, 10) float32
    inst: TileInstances
    grid: _TileGrid


def build_raster_inputs(means, quats, scales, opacities, colors, viewmat, K,
                        width: int, height: int,
                        sh_degree: Optional[int] = None,
                        cap: Optional[int] = None,
                        means2d_probe: Optional[torch.Tensor] = None
                        ) -> RasterInputs:
    """Projection, SH colour, cull and binning: the K1 launch's inputs.
    `cap` defaults to max(4N, G); it is rounded up to G, and instances
    beyond it are dropped and counted (`inst.n_dropped`).
    `means2d_probe` (N, 2), when given, is added to the projected means
    that go into the fields (and `proj.means2d`, a view of them), so its
    gradient is the screen-space gradient of the means; it is zero in
    use, so binning, which reads the field columns, bins the projected
    means. The JAX wrapper takes the sum as `means2d_override`."""
    grid = _make_grid(width, height, TILE_W, TILE_H)
    cap = _cap(cap, means.shape[0])
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    pf = project_fields_3dgs(
        means, quats, scales, opacities,
        lambda: _sh_rgb(colors, sh_degree, means, cam_pos), viewmat, K,
        width, height, means2d_probe)
    f = pf.fields.detach()
    inst = build_tile_instances(
        f[:, 0:2], pf.cull.detach(), f[:, 9], grid.n_tiles_x,
        grid.n_tiles_y, TILE_W, TILE_H, cap, conics=f[:, 2:5],
        opacities=opacities.detach())
    return RasterInputs(pf.proj, pf.fields, inst, grid)


class RasterCore(torch.autograd.Function):
    """K1 forward, K2 backward, at the (N, 10) field boundary.

    forward(fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y) ->
    (acc, logT, n_contrib) of `rasterize_fwd`; backward takes the
    cotangents of acc and of logT's row 0 (row 1, i_fin, and n_contrib are
    integer records with no gradient) and returns dL/dfields from
    `rasterize_bwd` (K2, or its plain version for CPU tensors)."""

    @staticmethod
    def forward(ctx, fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y):
        acc, logT, n_contrib = rasterize_fwd(fields, gauss_id, tile_starts,
                                             n_tiles_x, n_tiles_y)
        ctx.save_for_backward(fields, gauss_id, tile_starts, logT, n_contrib)
        ctx.n_tiles = (n_tiles_x, n_tiles_y)
        ctx.mark_non_differentiable(n_contrib)
        return acc, logT, n_contrib

    @staticmethod
    def backward(ctx, d_acc, d_logT, _d_n_contrib):
        fields, gauss_id, tile_starts, logT, n_contrib = ctx.saved_tensors
        grad = rasterize_bwd(fields, gauss_id, tile_starts,
                             d_acc.contiguous(),
                             d_logT[:, 0].contiguous(),
                             logT[:, 0].contiguous(), n_contrib,
                             *ctx.n_tiles)
        return grad, None, None, None, None


def rasterize_cuda_3dgs(
    means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
    opacities: torch.Tensor, colors: torch.Tensor,
    viewmat: torch.Tensor, K: torch.Tensor, width: int, height: int,
    background: torch.Tensor, sh_degree: Optional[int] = None,
    render_mode: str = "RGB", cap: Optional[int] = None,
    means2d_probe: Optional[torch.Tensor] = None,
):
    """3DGS rasterization through K1, differentiable through K2. colors
    are RGB (N, 3) or SH (N, K, 3). Returns (render (H, W, C), alphas
    (H, W, 1), info) with the outputs and `info` keys of the JAX package's
    `rasterize_pallas_3dgs`. `means2d_probe`: see `build_raster_inputs`."""
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    with tracing.span("render.bin"):
        ri = build_raster_inputs(means, quats, scales, opacities, colors,
                                 viewmat, K, width, height,
                                 sh_degree=sh_degree, cap=cap,
                                 means2d_probe=means2d_probe)
    _count_instances(ri.inst)
    grid = ri.grid
    with tracing.span("render.composite"):
        # (n_tiles, 5, P), (n_tiles, 2, P)
        acc, logT2, _ = RasterCore.apply(ri.fields, ri.inst.gauss_id,
                                         ri.inst.tile_starts, grid.n_tiles_x,
                                         grid.n_tiles_y)
        render, alphas = _assemble(acc[:, 0:3], acc[:, 4:5], acc[:, 3:4],
                                   logT2[:, 0:1], background, grid, width,
                                   height, render_mode)
    proj = ri.proj
    info = {"radii": proj.radii, "means2d": proj.means2d,
            "depths": proj.depths, "conics": proj.conics,
            "n_instances": ri.inst.n_instances,
            "n_dropped": ri.inst.n_dropped}
    return render, alphas, info


def _count_instances(inst) -> None:
    """The view's tile instances (before any drop) and their capacity, as
    the counters `render.instances` and `render.instance_cap`."""
    tracing.count("render.instances", inst.n_instances)
    tracing.count("render.instance_cap", inst.gauss_id.shape[0])


def _assemble(color, alpha, depth, logT, background, grid: _TileGrid,
              width: int, height: int, render_mode: str):
    """Tile rows (n_tiles, C, P) -> (render (H, W, C'), alphas (H, W, 1)):
    colour plus T_final x background, and for "RGB+D" / "RGB+ED" the depth
    sum or D / max(alpha, 1e-10) as a last channel."""
    def image(rows):
        return _tiles_to_image(rows.transpose(1, 2), grid, height, width)

    render = image(color + torch.exp(logT) * background[None, :, None])
    alphas = image(alpha)
    if render_mode == "RGB+D":
        render = torch.cat([render, image(depth)], dim=-1)
    elif render_mode == "RGB+ED":
        render = torch.cat(
            [render, image(depth / torch.clamp_min(alpha, 1e-10))], dim=-1)
    return render, alphas


# ---------------------------------------------------------------------------
# 2DGS
# ---------------------------------------------------------------------------

def count_instances_2dgs(means, quats, scales, opacities, viewmat, K,
                         width: int, height: int) -> torch.Tensor:
    """Instance count `rasterize_cuda_2dgs` enumerates for this view (its
    cull radius with the low-pass guard, circle spans over 32x16 tiles);
    feed the max over sample views to `suggest_instance_cap`."""
    grid = _make_grid(width, height, raster2d.TILE_W, raster2d.TILE_H)
    proj = project_2dgs(means, quats, scales, viewmat, K, width, height)
    return count_tile_instances(
        proj.means2d, _cull_radii(proj, opacities, GUARD_PX_2DGS),
        grid.n_tiles_x, grid.n_tiles_y, raster2d.TILE_W, raster2d.TILE_H)


class RasterInputs2D(NamedTuple):
    """What K3 is launched on for one view, and what the wrapper needs
    around it."""
    proj: ProjectedSurfels
    fields: torch.Tensor      # (N, 18) float32
    inst: TileInstances
    grid: _TileGrid


def build_raster_inputs_2dgs(means, quats, scales, opacities, colors,
                             viewmat, K, width: int, height: int,
                             sh_degree: Optional[int] = None,
                             cap: Optional[int] = None,
                             means2d_probe: Optional[torch.Tensor] = None
                             ) -> RasterInputs2D:
    """Surfel projection, SH colour, the guarded cull (guard 2.2 px) and
    circle binning over 32x16 tiles: the K3 launch's inputs. `cap` and
    `means2d_probe` as in `build_raster_inputs`; the probe moves only the
    centre of the screen-space low-pass (fields mx, my)."""
    grid = _make_grid(width, height, raster2d.TILE_W, raster2d.TILE_H)
    cap = _cap(cap, means.shape[0])
    with tracing.span("render.project"):
        proj = project_2dgs(means, quats, scales, viewmat, K, width, height)
    tracing.count("render.project_rows", means.shape[0])
    tracing.count("render.project_rows_card", 0)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_rgb(colors, sh_degree, means, cam_pos)
    inst = build_tile_instances(
        proj.means2d.detach(),
        _cull_radii(proj, opacities, GUARD_PX_2DGS).detach(),
        proj.depths.detach(), grid.n_tiles_x, grid.n_tiles_y,
        raster2d.TILE_W, raster2d.TILE_H, cap)
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    M = proj.transforms
    fields = torch.cat([M[:, 0, :], M[:, 1, :], M[:, 2, :], proj.means2d,
                        opacities[:, None], rgb, proj.normals],
                       dim=-1).contiguous()
    return RasterInputs2D(proj, fields, inst, grid)


class RasterCore2D(torch.autograd.Function):
    """K3 forward, K4 backward, at the (N, 18) field boundary.

    forward(fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y, row0=0)
    -> (acc, aux, rec) of `rasterize2d_fwd`; backward takes the cotangents
    of acc and aux (rec is an integer record with no gradient) and returns
    dL/dfields from `rasterize2d_bwd` (K4, or its plain version for CPU
    tensors). `row0` is the first pixel row (a band of a view)."""

    @staticmethod
    def forward(ctx, fields, gauss_id, tile_starts, n_tiles_x, n_tiles_y,
                row0=0):
        acc, aux, rec = rasterize2d_fwd(fields, gauss_id, tile_starts,
                                        n_tiles_x, n_tiles_y, row0)
        ctx.save_for_backward(fields, gauss_id, tile_starts, acc, aux, rec)
        ctx.n_tiles = (n_tiles_x, n_tiles_y, row0)
        ctx.mark_non_differentiable(rec)
        return acc, aux, rec

    @staticmethod
    def backward(ctx, d_acc, d_aux, _d_rec):
        fields, gauss_id, tile_starts, acc, aux, rec = ctx.saved_tensors
        grad = rasterize2d_bwd(fields, gauss_id, tile_starts,
                               d_acc.contiguous(), d_aux.contiguous(), acc,
                               aux, rec, *ctx.n_tiles)
        return grad, None, None, None, None, None


def rasterize_cuda_2dgs(
    means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
    opacities: torch.Tensor, colors: torch.Tensor,
    viewmat: torch.Tensor, K: torch.Tensor, width: int, height: int,
    background: torch.Tensor, sh_degree: Optional[int] = None,
    render_mode: str = "RGB", cap: Optional[int] = None,
    means2d_probe: Optional[torch.Tensor] = None,
):
    """2DGS rasterization through K3, differentiable through K4. Returns
    the JAX package's `rasterize_pallas_2dgs` tuple: (render (H, W, C),
    alphas (H, W, 1), normals (H, W, 3), normals_from_depth (H, W, 3),
    distort (H, W, 1), median depth (H, W, 1), info)."""
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    with tracing.span("render.bin"):
        ri = build_raster_inputs_2dgs(means, quats, scales, opacities,
                                      colors, viewmat, K, width, height,
                                      sh_degree=sh_degree, cap=cap,
                                      means2d_probe=means2d_probe)
    _count_instances(ri.inst)
    grid = ri.grid
    with tracing.span("render.composite"):
        # (n_tiles, 7, P), (n_tiles, 4, P)
        acc, aux, _ = RasterCore2D.apply(ri.fields, ri.inst.gauss_id,
                                         ri.inst.tile_starts, grid.n_tiles_x,
                                         grid.n_tiles_y)
        render, alphas = _assemble(acc[:, 0:3], acc[:, 6:7], aux[:, 1:2],
                                   aux[:, 0:1], background, grid, width,
                                   height, render_mode)
        normals, distort, median = (
            _tiles_to_image(rows.transpose(1, 2), grid, height, width)
            for rows in (acc[:, 3:6], aux[:, 2:3], aux[:, 3:4]))
        normals_from_depth = depth_to_normals(median[..., 0], K)
    proj = ri.proj
    info = {"radii": proj.radii, "means2d": proj.means2d,
            "depths": proj.depths, "n_instances": ri.inst.n_instances,
            "n_dropped": ri.inst.n_dropped}
    return render, alphas, normals, normals_from_depth, distort, median, info
