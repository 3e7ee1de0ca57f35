"""CUDA-backed 3DGS rasterization, the counterpart of the JAX package's
`ops/raster_pallas.py`: projection, SH colour and binning in PyTorch, the
per-tile compositing in the hand-written K1 kernel (`ops/raster3d.py`).

The kernel boundary is the packed per-gaussian field matrix (N, 10):
[mx, my, conic_a, conic_b, conic_c, opacity, r, g, b, depth]. This slice is
forward only: the backward kernel (K2) and its gradient routing arrive with
the training slice, so an input that requires grad is refused.
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
from horizongs_tpu_torch.ops.raster3d import G, TILE_H, TILE_W, rasterize_fwd
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
                        cap: Optional[int] = None) -> RasterInputs:
    """Projection, SH colour, cull and binning: the K1 launch's inputs.
    `cap` defaults to max(4N, G); it is rounded up to G, and instances
    beyond it are dropped and counted (`inst.n_dropped`)."""
    N = means.shape[0]
    grid = _make_grid(width, height, TILE_W, TILE_H)
    cap = cap if cap is not None else max(4 * N, G)
    cap = -(-cap // G) * G

    proj = project_3dgs(means, quats, scales, viewmat, K, width, height)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_colors(colors, sh_degree, means, cam_pos)
    inst = build_tile_instances(proj.means2d, _cull_radii(proj, opacities),
                                proj.depths, proj.conics, opacities,
                                grid.n_tiles_x, grid.n_tiles_y, TILE_W,
                                TILE_H, cap)
    fields = torch.cat([proj.means2d, proj.conics, opacities[:, None], rgb,
                        proj.depths[:, None]], dim=-1).contiguous()
    return RasterInputs(proj, fields, inst, grid)


def rasterize_cuda_3dgs(
    means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
    opacities: torch.Tensor, colors: torch.Tensor,
    viewmat: torch.Tensor, K: torch.Tensor, width: int, height: int,
    background: torch.Tensor, sh_degree: Optional[int] = None,
    render_mode: str = "RGB", cap: Optional[int] = None,
):
    """Forward 3DGS rasterization through K1. colors are RGB (N, 3) or SH
    (N, K, 3). Returns (render (H, W, C), alphas (H, W, 1), info) with the
    outputs and `info` keys of the JAX package's `rasterize_pallas_3dgs`."""
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    if any(t.requires_grad for t in (means, quats, scales, opacities,
                                     colors, viewmat, K)):
        raise RuntimeError(
            "rasterize_cuda_3dgs is forward-only: the backward kernel (K2) "
            "arrives with the training slice of the port. Render under "
            "torch.no_grad().")
    ri = build_raster_inputs(means, quats, scales, opacities, colors,
                             viewmat, K, width, height, sh_degree=sh_degree,
                             cap=cap)
    grid = ri.grid
    acc, logT2 = rasterize_fwd(ri.fields, ri.inst.gauss_id,
                               ri.inst.tile_starts, grid.n_tiles_x,
                               grid.n_tiles_y)   # (n_tiles, 5, P), (n_tiles, 2, P)

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
