"""Anchor tables and Scaffold-GS neural-gaussian decoding.

Like the JAX package, the table is capacity-padded (`capacity` rows, `n`
alive) and visibility is a mask: a gaussian that is filtered out gets
opacity 0, which contributes exactly nothing to the composite, so every
shape stays fixed per capacity and the decode is three matmuls over the
whole table.

Numerics mirror Horizon-GS `generate_neural_gaussians`:
  * view direction = normalize(anchor - cam_center), concatenated to feat
  * neural opacity = tanh(MLP(feat, dir)) * smooth complement, kept > 0
  * scaling = exp(scaling_log)[3:6] * sigmoid(cov_mlp[..., :3])
  * rotation = normalize(cov_mlp[..., 3:7])
  * xyz = anchor + offset * exp(scaling_log)[0:3]
and `set_anchor_mask` / `map_to_int_level` for the LOD distance rule. The
initialisation from a point cloud is host-side numpy, identical to the
JAX package's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from horizongs_tpu_torch import tracing
from horizongs_tpu_torch.core.transforms import normalize_quat
from horizongs_tpu_torch.device import DeviceLike, resolve_device
from horizongs_tpu_torch.models.config import ModelConfig
from horizongs_tpu_torch.models.mlp import MlpDecoders


class AnchorState(NamedTuple):
    """Capacity-padded anchor table. Rows >= n are dead (zero) padding."""
    anchor: torch.Tensor       # (C, 3) positions
    offset: torch.Tensor       # (C, k, 3) child offsets
    feat: torch.Tensor         # (C, F) anchor features
    scaling_log: torch.Tensor  # (C, 6) log scales: [0:3] offset, [3:6] gaussian
    rotation: torch.Tensor     # (C, 4) wxyz
    level: torch.Tensor        # (C,) int32 LOD level (0 for the flat model)
    extra_level: torch.Tensor  # (C,) float32 LOD promotion
    n: int                     # live row count

    @property
    def capacity(self) -> int:
        return self.anchor.shape[0]

    @property
    def n_offsets(self) -> int:
        return self.offset.shape[1]

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.anchor.device) < self.n


class DecodedGaussians(NamedTuple):
    """Per-offset gaussians, flattened to (C*k, ...). Masked rows have
    opacity exactly 0; `selection_mask` keeps the mask itself."""
    means: torch.Tensor        # (C*k, 3)
    quats: torch.Tensor        # (C*k, 4)
    scales: torch.Tensor       # (C*k, 3)
    opacities: torch.Tensor    # (C*k,)
    colors: torch.Tensor       # (C*k, color_dim)
    selection_mask: torch.Tensor  # (C*k,) bool: opacity>0 & anchor visible
    anchor_mask: torch.Tensor     # (C,) bool: anchor visible (LOD+prefilter)


def map_to_int_level(cfg: ModelConfig, pred_level: torch.Tensor,
                     cur_level: int, level: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`map_to_int_level`: (int_level, prog_ratio, transition_mask); the
    latter two matter only for dist2level == "progressive"."""
    ones = torch.ones_like(pred_level)
    no_trans = torch.zeros(pred_level.shape, dtype=torch.bool,
                           device=pred_level.device)
    if cfg.dist2level == "floor":
        return (torch.floor(pred_level).int().clamp(0, cur_level),
                ones, no_trans)
    if cfg.dist2level == "round":
        return (torch.round(pred_level).int().clamp(0, cur_level),
                ones, no_trans)
    if cfg.dist2level == "ceil":
        return (torch.ceil(pred_level).int().clamp(0, cur_level),
                ones, no_trans)
    if cfg.dist2level == "progressive":
        p = torch.clamp(pred_level + 1.0, 0.9999, cur_level + 0.9999)
        int_level = torch.floor(p).int()
        return int_level, p - torch.floor(p), level == int_level
    raise ValueError(f"Unknown dist2level: {cfg.dist2level}")


def anchor_lod_mask(cfg: ModelConfig, state: AnchorState,
                    cam_center: torch.Tensor, resolution_scale: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`set_anchor_mask`: distance -> level gate. Returns (mask (C,),
    smooth complement (C,)), the complement being the progressive-LOD
    opacity fade (1.0 in the other modes)."""
    if not cfg.is_lod:
        return (state.valid_mask(),
                torch.ones(state.capacity, device=state.anchor.device))
    dist = torch.linalg.norm(state.anchor - cam_center[None, :], dim=-1)
    dist = torch.clamp_min(dist * resolution_scale, 1e-8)
    pred_level = (torch.log2(cfg.standard_dist / dist) / math.log2(cfg.fork)
                  + state.extra_level)
    int_level, prog, trans = map_to_int_level(
        cfg, pred_level, cfg.street_levels - 1, state.level)
    mask = (state.level <= int_level) & state.valid_mask()
    complement = torch.where(trans, prog, torch.ones_like(prog))
    return mask, complement


def decode_neural_gaussians(
    cfg: ModelConfig,
    mlps: MlpDecoders,
    state: AnchorState,
    cam_center: torch.Tensor,
    anchor_mask: torch.Tensor,                # (C,) visibility (LOD ∩ prefilter)
    smooth: Optional[torch.Tensor] = None,    # (C,) progressive-LOD fade
    appearance_id: int = 0,                   # camera uid
) -> DecodedGaussians:
    C, k = state.capacity, state.n_offsets
    feat = state.feat
    if tracing.recording():
        # the rows the MLPs below run over, and those the view needs
        tracing.count("render.anchor_rows", feat.shape[0])
        tracing.count("render.anchors_visible", anchor_mask.sum())
    ob_view = state.anchor - cam_center[None, :]
    ob_dist = torch.clamp_min(
        torch.linalg.norm(ob_view, dim=-1, keepdim=True), 1e-8)
    ob_view = ob_view / ob_dist

    cat = torch.cat([feat, ob_view], dim=-1) if cfg.view_dim > 0 else feat

    neural_opacity = mlps.opacity(cat)                        # (C, k)
    if smooth is not None:
        neural_opacity = neural_opacity * smooth[:, None]

    if cfg.appearance_dim > 0:
        if mlps.appearance is None:
            raise ValueError("appearance_dim > 0 needs an appearance table")
        code = appearance_id if cfg.ape_code < 0 else cfg.ape_code
        app = mlps.appearance[code].expand(C, cfg.appearance_dim)
        color = mlps.color(torch.cat([cat, app], dim=-1))
    else:
        color = mlps.color(cat)
    color = color.reshape(C, k, cfg.color_dim)

    scale_rot = mlps.cov(cat).reshape(C, k, 7)

    grid_scaling = torch.exp(state.scaling_log)               # (C, 6)
    scales = grid_scaling[:, None, 3:6] * torch.sigmoid(scale_rot[..., 0:3])
    quats = normalize_quat(scale_rot[..., 3:7])
    means = state.anchor[:, None, :] + state.offset * grid_scaling[:, None, 0:3]

    sel = (neural_opacity > 0.0) & anchor_mask[:, None]       # (C, k)
    opacity = torch.where(sel, neural_opacity,
                          torch.zeros_like(neural_opacity))

    return DecodedGaussians(
        means=means.reshape(C * k, 3),
        quats=quats.reshape(C * k, 4),
        scales=scales.reshape(C * k, 3),
        opacities=opacity.reshape(C * k),
        colors=color.reshape(C * k, cfg.color_dim),
        selection_mask=sel.reshape(C * k),
        anchor_mask=anchor_mask,
    )


# ---------------------------------------------------------------------------
# Host-side initialization (numpy): voxelization / octree sampling / KNN
# (`create_from_pcd` of both models). Runs once at scene build.
# ---------------------------------------------------------------------------

def round_capacity(n: int, block: int = 4096) -> int:
    return max(block, ((n + block - 1) // block) * block)


def voxelize(points: np.ndarray, voxel_size: float,
             padding: float = 0.0) -> np.ndarray:
    """`voxelize_sample`: snap-to-grid dedup."""
    q = np.unique(np.round(points / voxel_size), axis=0) * voxel_size
    return q + padding * voxel_size


def octree_sample(points: np.ndarray, cfg: ModelConfig
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """`octree_sample`: multi-level voxel grids; level l uses voxel size
    voxel_size / fork^(l + 1 - aerial_levels)."""
    pts_all, lv_all = [], []
    for lv in range(cfg.aerial_levels):
        size = cfg.voxel_size / (float(cfg.fork) ** (lv + 1 - cfg.aerial_levels))
        p = np.unique(np.round(points / size), axis=0) * size
        p = p + cfg.padding * size
        pts_all.append(p)
        lv_all.append(np.full(p.shape[0], lv, dtype=np.int32))
    return (np.concatenate(pts_all, axis=0).astype(np.float32),
            np.concatenate(lv_all, axis=0))


def knn_mean_sq_dist(points: np.ndarray, k: int = 4) -> np.ndarray:
    """Mean squared distance to the (k-1) nearest neighbours (excl. self)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    d, _ = tree.query(points, k=k)
    return (d[:, 1:] ** 2).mean(axis=1)


def init_anchor_state_from_points(
    cfg: ModelConfig,
    points: np.ndarray,
    capacity: Optional[int] = None,
    device: DeviceLike = None,
    weed_fn=None,
) -> AnchorState:
    """The initial padded anchor table from a raw point cloud: one voxel
    grid for the flat model (median-KNN voxel size if voxel_size <= 0),
    the octree sample for the LOD model. `weed_fn(positions, levels)`,
    when given, returns the rows to keep (`Scene` passes the camera
    weed-out, `weed_out_mask`)."""
    dev = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    voxel_size = cfg.voxel_size
    if cfg.is_lod:
        pts, levels = octree_sample(points, cfg)
    else:
        if voxel_size <= 0:
            voxel_size = float(np.median(knn_mean_sq_dist(points, 4)))
        pts = voxelize(points, voxel_size, cfg.padding).astype(np.float32)
        levels = np.zeros(pts.shape[0], dtype=np.int32)

    if weed_fn is not None:
        keep = weed_fn(pts, levels)
        pts, levels = pts[keep], levels[keep]

    n = pts.shape[0]
    C = capacity or round_capacity(n)
    k, F = cfg.n_offsets, cfg.feat_dim

    d2 = knn_mean_sq_dist(pts, 4) if n > 4 else np.full(n, voxel_size ** 2)
    scales = np.log(np.sqrt(np.clip(d2, 1e-12, None)))[:, None].repeat(6, axis=1)

    def pad(a):
        out = np.zeros((C,) + a.shape[1:], dtype=a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    rot = np.zeros((C, 4), dtype=np.float32)
    rot[:, 0] = 1.0

    return AnchorState(
        anchor=pad(pts),
        offset=torch.zeros((C, k, 3), dtype=torch.float32, device=dev),
        feat=torch.zeros((C, F), dtype=torch.float32, device=dev),
        scaling_log=pad(scales.astype(np.float32)),
        rotation=torch.from_numpy(rot).to(dev),
        level=pad(levels.astype(np.int32)),
        extra_level=torch.zeros((C,), dtype=torch.float32, device=dev),
        n=int(n),
    )


def weed_out_mask(cfg: ModelConfig, positions: np.ndarray, levels: np.ndarray,
                  cam_infos: np.ndarray, weed_ratio: float) -> np.ndarray:
    """`weed_out`: keep anchors visible (by the LOD distance rule) from
    more than `weed_ratio` of the training cameras. cam_infos: (M, 4) rows
    of [cam_center_xyz, resolution_scale]. Host-side numpy, the JAX
    package's arithmetic in its order; the cameras go in batches that bound
    each (B, N) distance matrix at about 64 MB."""
    if weed_ratio <= 0 or len(cam_infos) == 0:
        return np.ones(positions.shape[0], dtype=bool)
    N = positions.shape[0]
    count = np.zeros(N, dtype=np.int64)
    logfork = math.log2(cfg.fork)
    cam_infos = np.asarray(cam_infos, dtype=np.float32)
    batch = max(1, int(16_000_000 // max(N, 1)))
    for s in range(0, len(cam_infos), batch):
        centers = cam_infos[s:s + batch, :3]                 # (B, 3)
        scales = cam_infos[s:s + batch, 3:4]                 # (B, 1)
        d = positions[None, :, :] - centers[:, None, :]      # (B, N, 3)
        dist = np.clip(np.sqrt(np.einsum("bnd,bnd->bn", d, d)) * scales,
                       1e-8, None)
        pred = np.log2(cfg.standard_dist / dist) / logfork   # (B, N)
        if cfg.dist2level == "floor":
            int_level = np.clip(np.floor(pred), 0, cfg.street_levels - 1)
        elif cfg.dist2level == "round":
            int_level = np.clip(np.round(pred), 0, cfg.street_levels - 1)
        elif cfg.dist2level == "ceil":
            int_level = np.clip(np.ceil(pred), 0, cfg.street_levels - 1)
        else:  # progressive
            p = np.clip(pred + 1.0, 0.9999, cfg.street_levels - 1 + 0.9999)
            int_level = np.floor(p)
        count += (levels[None, :] <= int_level).sum(axis=0)
    frac = count / float(len(cam_infos))
    return frac > weed_ratio
