"""Explicit (baked, MLP-free) gaussians, the JAX package's
`models/explicit.py`.

`bake_explicit` is the reference's `save_explicit`
(`base_model.py:566-654`, `lod_model.py:681-780`): decode every live
anchor's offsets through the MLPs *without* a view direction (hence the
reference's contract color_attr == SH*, view_dim == 0,
`scene/__init__.py:159-164`), keep the children with neural opacity > 0,
and store plain 3DGS attributes: linear scales, the raw (tanh) opacity,
SH colour coefficients. The decode runs on the model's device and is
compacted there; only the kept rows go to numpy.

`ExplicitState` is the render-side table (`load_explicit` +
`generate_explicit_gaussians`, `basic_model.py:373-383`), tensors on one
device: the attributes go to the rasterizer as stored (no activations),
as in the reference's explicit render path (`render.py:22-25`).
`render_explicit` renders it through K1 (`rasterize_cuda_3dgs`) or the
dense oracle. Where the JAX package passes no instance capacity, the port
calibrates one from the view's own count (`count_explicit_instances`),
so nothing is dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from horizongs_tpu_torch.core.transforms import normalize_quat
from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.models.anchors import AnchorState, map_to_int_level
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders
from horizongs_tpu_torch.ops.raster_cuda import (
    count_instances_3dgs,
    rasterize_cuda_3dgs,
    suggest_instance_cap,
)
from horizongs_tpu_torch.ops.reference import render_dense_3dgs


class ExplicitState(NamedTuple):
    """Capacity-padded baked table; rows >= n are dead padding."""
    xyz: torch.Tensor          # (C, 3)
    features: torch.Tensor     # (C, K, 3) SH coefficients (DC first)
    opacity: torch.Tensor      # (C,) in (0, 1), stored raw
    scaling: torch.Tensor      # (C, 3) linear scales
    rotation: torch.Tensor     # (C, 4) wxyz
    level: torch.Tensor        # (C,) int32
    extra_level: torch.Tensor  # (C,)
    n: int                     # live row count

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.xyz.shape[0], device=self.xyz.device) < self.n


def explicit_gs_mask(cfg: ModelConfig, state: ExplicitState,
                     cam_center: torch.Tensor,
                     resolution_scale: float = 1.0) -> torch.Tensor:
    """`set_gs_mask` (`lod_model.py:292-296`): the LOD gate of each baked
    gaussian, from its own distance to the camera."""
    if not cfg.is_lod:
        return state.valid_mask()
    dist = torch.clamp_min(
        torch.linalg.norm(state.xyz - cam_center[None], dim=-1)
        * resolution_scale, 1e-8)
    pred = (torch.log2(cfg.standard_dist / dist) / math.log2(cfg.fork)
            + state.extra_level)
    int_level, _, _ = map_to_int_level(cfg, pred, cfg.street_levels - 1,
                                       state.level)
    return (state.level <= int_level) & state.valid_mask()


@torch.no_grad()
def decode_explicit(cfg: ModelConfig, mlps: MlpDecoders,
                    state: AnchorState) -> dict:
    """Every child of the n live anchors, decoded without a view
    direction, on the model's device: xyz, features (n*k, K, 3), opacity
    (the neural opacity, uncompacted), scaling, rotation, level and
    extra_level, row i*k + j the j-th offset of anchor i."""
    if cfg.color_attr == "RGB":
        raise ValueError("the explicit bake needs SH colours "
                         "(reference scene/__init__.py:159)")
    if cfg.view_dim != 0:
        raise ValueError("the explicit bake needs view_dim == 0 "
                         "(the reference's contract)")
    n, k = state.n, state.n_offsets
    feat = state.feat
    grid_scaling = torch.exp(state.scaling_log[:n])

    # the decoders run over the whole table and keep the live rows, as the
    # neural decode does: a bake and a neural render of one model then
    # share their products to the last bit
    neural_op = mlps.opacity(feat)[:n].reshape(n * k)    # tanh included
    if cfg.appearance_dim > 0 and mlps.appearance is not None:
        app = mlps.appearance[0].expand(feat.shape[0], -1)
        color = mlps.color(torch.cat([feat, app], dim=-1))[:n]
    else:
        color = mlps.color(feat)[:n]
    scale_rot = mlps.cov(feat)[:n].reshape(n * k, 7)

    def per_child(x):
        return torch.repeat_interleave(x, k, dim=0)

    return {
        "xyz": (per_child(state.anchor[:n])
                + state.offset[:n].reshape(n * k, 3)
                * per_child(grid_scaling[:, 0:3])),
        "features": color.reshape(n * k, cfg.color_dim // 3, 3),
        "opacity": neural_op,
        "scaling": (per_child(grid_scaling[:, 3:6])
                    * torch.sigmoid(scale_rot[:, 0:3])),
        "rotation": normalize_quat(scale_rot[:, 3:7]),
        "level": per_child(state.level[:n]).int(),
        "extra_level": per_child(state.extra_level[:n]),
    }


def bake_explicit(cfg: ModelConfig, mlps: MlpDecoders,
                  state: AnchorState) -> dict:
    """The explicit gaussians as numpy arrays: `decode_explicit`'s rows
    with neural opacity > 0, compacted on the device."""
    dec = decode_explicit(cfg, mlps, state)
    keep = dec["opacity"] > 0.0
    return {k: v[keep].cpu().numpy() for k, v in dec.items()}


def explicit_state_from_arrays(arrays: dict, capacity: Optional[int] = None,
                               device: DeviceLike = None) -> ExplicitState:
    """Baked arrays (`bake_explicit`, `load_explicit_ply`) -> a table of
    `capacity` rows (default: n rounded up to 128) on `device`."""
    dev = resolve_device(device)
    n = arrays["xyz"].shape[0]
    C = capacity or max(128, -(-n // 128) * 128)

    def pad(a):
        out = np.zeros((C,) + a.shape[1:], dtype=a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    rot = np.zeros((C, 4), dtype=np.float32)
    rot[:, 0] = 1.0
    rot[:n] = arrays["rotation"]
    return ExplicitState(
        xyz=pad(arrays["xyz"]), features=pad(arrays["features"]),
        opacity=pad(arrays["opacity"]), scaling=pad(arrays["scaling"]),
        rotation=torch.from_numpy(rot).to(dev),
        level=pad(arrays.get("level", np.zeros(n, np.int32))),
        extra_level=pad(arrays.get("extra_level", np.zeros(n, np.float32))),
        n=n)


def _masked_opacity(cam, cfg: ModelConfig, state: ExplicitState):
    mask = explicit_gs_mask(cfg, state, cam.cam_center, cam.resolution_scale)
    return torch.where(mask, state.opacity, 0.0), mask


def count_explicit_instances(cam, cfg: ModelConfig,
                             state: ExplicitState) -> int:
    """Tile-instance count K1's path enumerates for this view of the baked
    table; calibrate `render_explicit(instance_cap=...)` with it."""
    opac, _ = _masked_opacity(cam, cfg, state)
    return int(count_instances_3dgs(state.xyz, state.rotation, state.scaling,
                                    opac, cam.viewmat, cam.K, cam.width,
                                    cam.height))


def render_explicit(cam, cfg: ModelConfig, state: ExplicitState,
                    background: torch.Tensor, rasterizer: str = "cuda",
                    active_sh_degree: Optional[int] = None,
                    instance_cap: Optional[int] = None) -> dict:
    """The explicit render path (`render.py:22-25` and its rasterization
    call), through K1 (`rasterizer="cuda"`) or the dense oracle. The cuda
    path's `instance_cap` defaults to this view's own count x 1.15, so it
    drops nothing; `pkg["n_dropped"]` counts what a smaller cap drops."""
    if rasterizer not in ("cuda", "dense"):
        raise ValueError(f"Unknown rasterizer: {rasterizer}")
    opac, mask = _masked_opacity(cam, cfg, state)
    sh_degree = (cfg.max_sh_degree if active_sh_degree is None
                 else active_sh_degree)
    args = (state.xyz, state.rotation, state.scaling, opac, state.features,
            cam.viewmat, cam.K, cam.width, cam.height, background)
    kw = dict(sh_degree=sh_degree, render_mode=cfg.render_mode)
    if rasterizer == "dense":
        out, alphas, info = render_dense_3dgs(*args, **kw)
    else:
        if instance_cap is None:
            instance_cap = suggest_instance_cap(
                count_explicit_instances(cam, cfg, state), margin=1.15)
        out, alphas, info = rasterize_cuda_3dgs(*args, cap=instance_cap,
                                                **kw)
    if out.shape[-1] == 4:
        image, depth = out[..., :3], out[..., 3:4]
    else:
        image, depth = out, None
    zero = torch.zeros((), dtype=torch.int32, device=out.device)
    return {"render": image, "render_depth": depth, "render_alphas": alphas,
            "radii": info["radii"], "visibility_filter": info["radii"] > 0,
            "gs_mask": mask, "n_dropped": info.get("n_dropped", zero),
            "n_instances": info.get("n_instances", zero)}
