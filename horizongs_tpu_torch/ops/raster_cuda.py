"""CUDA-backed 3DGS rasterization, the counterpart of the JAX package's
`ops/raster_pallas.py`: projection, SH colour and binning in PyTorch, the
per-tile compositing in the hand-written kernels K1 (forward) and K2
(backward) of `ops/raster3d.py`.

The kernel boundary is the packed per-gaussian field matrix (N, 10):
[mx, my, conic_a, conic_b, conic_c, opacity, r, g, b, depth], wrapped in a
`torch.autograd.Function` (`RasterCore`, the JAX package's `_raster_core`
custom VJP). Everything before it (EWA projection, SH colour, the neural
decode) and after it (background blend, depth modes, losses)
differentiates with ordinary autograd; binning sees detached inputs, as
the JAX wrapper's `stop_gradient`s make it.

Gradient routing: K2 adds each instance's gradient into its gaussian's row
of the (N, 10) field gradient itself (atomics), so the JAX package's
routing fields and steps — `grad_slot`, `out_starts`, `inv_perm` and the
un-sort + cumsum of `_instance_grads_to_fields` — have no counterpart
here. Without a gradient (serving under `torch.no_grad()`, or no input
requiring one) autograd records no node, so nothing is kept for backward.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from horizongs_tpu_torch.ops.binning import (
    TileInstances,
    build_tile_instances,
    count_tile_instances,
    cull_radius,
)
from horizongs_tpu_torch.ops.projection import ProjectedGaussians, project_3dgs
from horizongs_tpu_torch.ops.raster import _TileGrid, _make_grid, _tiles_to_image
from horizongs_tpu_torch.ops.raster3d import (
    G,
    TILE_H,
    TILE_W,
    rasterize_bwd,
    rasterize_fwd,
)
from horizongs_tpu_torch.ops.reference import ALPHA_CUTOFF, _sh_colors


def suggest_instance_cap(n_instances: int, margin: float = 1.25) -> int:
    """Round a measured instance count (times `margin`) up to a geometric
    capacity bucket (8 per octave, G-aligned), as the JAX package does."""
    b = 8
    need = max(int(math.ceil(n_instances * margin)), G)
    k = max(int(math.ceil(b * math.log2(need / G))), 0)
    cap = int(math.ceil(G * 2 ** (k / b)))
    return -(-cap // G) * G


def _cull_radii(proj: ProjectedGaussians, opacities: torch.Tensor):
    # gaussians below the alpha cutoff can never contribute: not binned
    return torch.where(opacities >= ALPHA_CUTOFF,
                       cull_radius(proj.radii, opacities),
                       torch.zeros_like(proj.radii))


def count_instances_3dgs(means, quats, scales, opacities, viewmat, K,
                         width: int, height: int) -> torch.Tensor:
    """Instance count `rasterize_cuda_3dgs` enumerates for this view;
    feed the max over sample views to `suggest_instance_cap`."""
    grid = _make_grid(width, height, TILE_W, TILE_H)
    proj = project_3dgs(means, quats, scales, viewmat, K, width, height)
    return count_tile_instances(proj.means2d, _cull_radii(proj, opacities),
                                proj.conics, opacities, grid.n_tiles_x,
                                grid.n_tiles_y, TILE_W, TILE_H)


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
    that go into the fields (and `proj.means2d`), so its gradient is the
    screen-space gradient of the means; binning never sees it (it is zero
    in use). The JAX wrapper takes the sum as `means2d_override`."""
    N = means.shape[0]
    grid = _make_grid(width, height, TILE_W, TILE_H)
    cap = cap if cap is not None else max(4 * N, G)
    cap = -(-cap // G) * G

    proj = project_3dgs(means, quats, scales, viewmat, K, width, height)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_colors(colors, sh_degree, means, cam_pos)
    inst = build_tile_instances(
        proj.means2d.detach(), _cull_radii(proj, opacities).detach(),
        proj.depths.detach(), proj.conics.detach(), opacities.detach(),
        grid.n_tiles_x, grid.n_tiles_y, TILE_W, TILE_H, cap)
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    fields = torch.cat([proj.means2d, proj.conics, opacities[:, None], rgb,
                        proj.depths[:, None]], dim=-1).contiguous()
    return RasterInputs(proj, fields, inst, grid)


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
    ri = build_raster_inputs(means, quats, scales, opacities, colors,
                             viewmat, K, width, height, sh_degree=sh_degree,
                             cap=cap, means2d_probe=means2d_probe)
    grid = ri.grid
    # (n_tiles, 5, P), (n_tiles, 2, P)
    acc, logT2, _ = RasterCore.apply(ri.fields, ri.inst.gauss_id,
                                     ri.inst.tile_starts, grid.n_tiles_x,
                                     grid.n_tiles_y)

    color_t = acc[:, 0:3, :].transpose(1, 2)              # (n_tiles, P, 3)
    depth_t = acc[:, 3:4, :].transpose(1, 2)
    alpha_t = acc[:, 4:5, :].transpose(1, 2)
    T_final = torch.exp(logT2[:, 0:1, :].transpose(1, 2))  # (n_tiles, P, 1)

    render = _tiles_to_image(color_t + T_final * background[None, None, :],
                             grid, height, width)
    alphas = _tiles_to_image(alpha_t, grid, height, width)
    if render_mode == "RGB+D":
        render = torch.cat(
            [render, _tiles_to_image(depth_t, grid, height, width)], dim=-1)
    elif render_mode == "RGB+ED":
        ed = depth_t / torch.clamp_min(alpha_t, 1e-10)
        render = torch.cat(
            [render, _tiles_to_image(ed, grid, height, width)], dim=-1)

    proj = ri.proj
    info = {"radii": proj.radii, "means2d": proj.means2d,
            "depths": proj.depths, "conics": proj.conics,
            "n_instances": ri.inst.n_instances,
            "n_dropped": ri.inst.n_dropped}
    return render, alphas, info
