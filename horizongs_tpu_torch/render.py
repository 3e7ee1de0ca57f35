"""Render layer: camera + model -> output dict, the serving entry point.

LOD anchor mask -> optional frustum prefilter -> neural-gaussian decode ->
3DGS rasterization, through the K1 CUDA kernel (`rasterizer="cuda"`, the
counterpart of the JAX package's Pallas path) or the dense oracle
(`"dense"`). Images are HWC float32 on the model's device. This slice is
forward only: render under `torch.no_grad()`.
"""
from __future__ import annotations

from typing import Optional

import torch

from horizongs_tpu_torch.core.cameras import Camera
from horizongs_tpu_torch.models.anchors import (
    AnchorState,
    DecodedGaussians,
    anchor_lod_mask,
    decode_neural_gaussians,
)
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders
from horizongs_tpu_torch.ops.projection import project_3dgs
from horizongs_tpu_torch.ops.raster_cuda import (
    count_instances_3dgs,
    rasterize_cuda_3dgs,
)
from horizongs_tpu_torch.ops.reference import render_dense_3dgs


def _require_3dgs(cfg: ModelConfig) -> None:
    if cfg.gs_attr == "2D":
        raise NotImplementedError(
            "2DGS (gs_attr='2D') arrives with the 2DGS slice of the port "
            "(kernels K3/K4)")
    if cfg.gs_attr != "3D":
        raise ValueError(f"Unknown gs_attr: {cfg.gs_attr}")


def prefilter_anchors(cfg: ModelConfig, state: AnchorState, cam: Camera,
                      anchor_mask: torch.Tensor) -> torch.Tensor:
    """Frustum prefilter: project anchors as gaussians with their offset
    scales and keep radii > 0 (`prefilter_voxel`)."""
    _require_3dgs(cfg)
    scales = torch.exp(state.scaling_log)[:, :3]
    proj = project_3dgs(state.anchor, state.rotation, scales, cam.viewmat,
                        cam.K, cam.width, cam.height)
    return anchor_mask & (proj.radii > 0)


def decode_view(cam: Camera, cfg: ModelConfig, mlps: MlpDecoders,
                state: AnchorState, add_prefilter: bool = True
                ) -> DecodedGaussians:
    """The gaussians one view sees: LOD mask, prefilter, decode."""
    anchor_mask, smooth = anchor_lod_mask(cfg, state, cam.cam_center,
                                          cam.resolution_scale)
    if add_prefilter:
        anchor_mask = prefilter_anchors(cfg, state, cam, anchor_mask)
    return decode_neural_gaussians(cfg, mlps, state, cam.cam_center,
                                   anchor_mask, smooth,
                                   appearance_id=int(cam.uid))


def render(cam: Camera,
           cfg: ModelConfig,
           mlps: MlpDecoders,
           state: AnchorState,
           background: torch.Tensor,
           add_prefilter: bool = True,
           rasterizer: str = "cuda",
           instance_cap: Optional[int] = None) -> dict:
    """`instance_cap`: the (gaussian, tile) instance capacity of the cuda
    path (default max(4N, G)); calibrate it with `count_render_instances`
    and `ops.raster_cuda.suggest_instance_cap`. Overflow is counted, never
    silent (`pkg["n_dropped"]`)."""
    _require_3dgs(cfg)
    dec = decode_view(cam, cfg, mlps, state, add_prefilter)
    colors = dec.colors
    if cfg.color_attr != "RGB":
        colors = colors.reshape(-1, cfg.color_dim // 3, 3)
    sh_degree = cfg.max_sh_degree

    args = (dec.means, dec.quats, dec.scales, dec.opacities, colors,
            cam.viewmat, cam.K, cam.width, cam.height, background)
    if rasterizer == "cuda":
        out, alphas, info = rasterize_cuda_3dgs(
            *args, sh_degree=sh_degree, render_mode=cfg.render_mode,
            cap=instance_cap)
    elif rasterizer == "dense":
        out, alphas, info = render_dense_3dgs(
            *args, sh_degree=sh_degree, render_mode=cfg.render_mode)
    else:
        raise ValueError(f"Unknown rasterizer: {rasterizer}")

    if out.shape[-1] == 4:
        image, depth = out[..., :3], out[..., 3:4]
    else:
        image, depth = out, None
    zero = torch.zeros((), dtype=torch.int32, device=out.device)
    return {
        "render": image,                       # (H, W, 3)
        "render_depth": depth,                 # (H, W, 1) or None
        "render_alphas": alphas,               # (H, W, 1)
        "scaling": dec.scales,                 # (C*k, 3)
        "opacity": dec.opacities,              # (C*k,)
        "selection_mask": dec.selection_mask,  # (C*k,)
        "visible_mask": dec.anchor_mask,       # (C,)
        "radii": info["radii"],                # (C*k,)
        "visibility_filter": info["radii"] > 0,
        "means2d": info["means2d"],
        # cuda path: instances beyond the capacity (0 for the dense oracle)
        "n_dropped": info.get("n_dropped", zero),
        "n_instances": info.get("n_instances", zero),
    }


def count_render_instances(cam: Camera, cfg: ModelConfig, mlps: MlpDecoders,
                           state: AnchorState,
                           add_prefilter: bool = True) -> int:
    """Tile-instance count the cuda path enumerates for this view with the
    current model: LOD mask -> decode -> projection + lossless cull + AABB
    spans. Take the max over a few cameras to calibrate
    `render(instance_cap=...)` via `suggest_instance_cap`."""
    _require_3dgs(cfg)
    with torch.no_grad():
        dec = decode_view(cam, cfg, mlps, state, add_prefilter)
        n = count_instances_3dgs(dec.means, dec.quats, dec.scales,
                                 dec.opacities, cam.viewmat, cam.K,
                                 cam.width, cam.height)
    return int(n)
