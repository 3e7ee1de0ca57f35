"""Render layer: camera + model -> output dict, the entry point of serving
and of the training step.

LOD anchor mask -> optional frustum prefilter -> neural-gaussian decode ->
rasterization, 3DGS (`gs_attr="3D"`) through the K1/K2 CUDA kernels or 2DGS
(surfels, `gs_attr="2D"`) through K3/K4 (`rasterizer="cuda"`, the
counterpart of the JAX package's Pallas path), or the dense oracle
(`"dense"`). Images are HWC float32 on the model's device. The render is
differentiable in the model's tensors (K2 and K4 carry the gradient
through the compositor); serve under `torch.no_grad()`, where nothing is
kept for a backward pass. 2DGS adds `render_normals`,
`render_normals_from_depth`, `render_distort` and `render_median_depth`
to the output.

`means2d_probe` is the handle for the screen-space gradients the
densification statistics need (the JAX package's argument of the same
name, in place of torch's `means2d.retain_grad()`): pass a zero (C*k, 2)
tensor that requires grad, and after the backward its `.grad` is the
gradient of the loss with respect to the projected means.
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
from horizongs_tpu_torch.ops.projection import project_2dgs, project_3dgs
from horizongs_tpu_torch.ops.raster_cuda import (
    count_instances_2dgs,
    count_instances_3dgs,
    rasterize_cuda_2dgs,
    rasterize_cuda_3dgs,
)
from horizongs_tpu_torch.ops.reference import (
    render_dense_2dgs,
    render_dense_3dgs,
)

_PROJECT = {"3D": project_3dgs, "2D": project_2dgs}
_COUNT = {"3D": count_instances_3dgs, "2D": count_instances_2dgs}
_RASTERIZE = {("3D", "cuda"): rasterize_cuda_3dgs,
              ("3D", "dense"): render_dense_3dgs,
              ("2D", "cuda"): rasterize_cuda_2dgs,
              ("2D", "dense"): render_dense_2dgs}


def _check_gs_attr(cfg: ModelConfig) -> None:
    if cfg.gs_attr not in _PROJECT:
        raise ValueError(f"Unknown gs_attr: {cfg.gs_attr}")


def prefilter_anchors(cfg: ModelConfig, state: AnchorState, cam: Camera,
                      anchor_mask: torch.Tensor) -> torch.Tensor:
    """Frustum prefilter: project anchors as gaussians (3DGS) or surfels
    (2DGS) with their offset scales and keep radii > 0
    (`prefilter_voxel`)."""
    _check_gs_attr(cfg)
    scales = torch.exp(state.scaling_log)[:, :3]
    proj = _PROJECT[cfg.gs_attr](state.anchor, state.rotation, scales,
                                 cam.viewmat, cam.K, cam.width, cam.height)
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
           instance_cap: Optional[int] = None,
           means2d_probe: Optional[torch.Tensor] = None) -> dict:
    """`instance_cap`: the (gaussian, tile) instance capacity of the cuda
    path (default max(4N, G)); calibrate it with `count_render_instances`
    and `ops.raster_cuda.suggest_instance_cap`. Overflow is counted, never
    silent (`pkg["n_dropped"]`). `means2d_probe`: see the module
    docstring."""
    _check_gs_attr(cfg)
    if rasterizer not in ("cuda", "dense"):
        raise ValueError(f"Unknown rasterizer: {rasterizer}")
    dec = decode_view(cam, cfg, mlps, state, add_prefilter)
    colors = dec.colors
    if cfg.color_attr != "RGB":
        colors = colors.reshape(-1, cfg.color_dim // 3, 3)

    kw = dict(sh_degree=cfg.max_sh_degree, render_mode=cfg.render_mode,
              means2d_probe=means2d_probe)
    if rasterizer == "cuda":
        kw["cap"] = instance_cap
    # 3DGS: (render, alphas, info); 2DGS adds four maps before info
    out, alphas, *surfel_maps, info = _RASTERIZE[cfg.gs_attr, rasterizer](
        dec.means, dec.quats, dec.scales, dec.opacities, colors,
        cam.viewmat, cam.K, cam.width, cam.height, background, **kw)

    if out.shape[-1] == 4:
        image, depth = out[..., :3], out[..., 3:4]
    else:
        image, depth = out, None
    zero = torch.zeros((), dtype=torch.int32, device=out.device)
    pkg = {
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
    if surfel_maps:
        pkg.update(zip(("render_normals", "render_normals_from_depth",
                        "render_distort", "render_median_depth"),
                       surfel_maps))
    return pkg


def count_render_instances(cam: Camera, cfg: ModelConfig, mlps: MlpDecoders,
                           state: AnchorState,
                           add_prefilter: bool = True) -> int:
    """Tile-instance count the cuda path enumerates for this view with the
    current model: LOD mask -> decode -> projection + lossless cull + AABB
    spans. Take the max over a few cameras to calibrate
    `render(instance_cap=...)` via `suggest_instance_cap`."""
    _check_gs_attr(cfg)
    with torch.no_grad():
        dec = decode_view(cam, cfg, mlps, state, add_prefilter)
        n = _COUNT[cfg.gs_attr](dec.means, dec.quats, dec.scales,
                                dec.opacities, cam.viewmat, cam.K,
                                cam.width, cam.height)
    return int(n)
