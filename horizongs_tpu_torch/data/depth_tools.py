"""Depth-map tooling: back-projection to point clouds + mono-depth
scale/offset fitting.

Equivalents of the reference's `preprocess/depth2pc.py` (RGB-D ->
world-space points, used to densify street-view chunks during
partitioning) and `preprocess/make_depth_scale.py:60-76` (fit per-image
scale/offset of inverse mono-depth against COLMAP sparse depth by
median/MAD). A copy of `horizongs_tpu/data/depth_tools.py` (this package
imports nothing of the JAX package): host numpy in both packages, no
device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def depth_to_points(depth: np.ndarray, K: np.ndarray, c2w: np.ndarray,
                    rgb: Optional[np.ndarray] = None,
                    max_depth: float = np.inf, stride: int = 1,
                    depth_scale: float = 1.0
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Back-project a depth map to world points (`depth2pc.py:20-94`).

    depth (H, W) metric camera-z depth (after `depth_scale`, e.g. the
    MatrixCity cm -> 100 m factor, `depth2pc.py:37`); K (3,3);
    c2w (4,4). Returns (points (M,3), colors (M,3) or None)."""
    d = np.asarray(depth, dtype=np.float64) * depth_scale
    H, W = d.shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    z = d[ys, xs]
    valid = (z > 0) & (z < max_depth) & np.isfinite(z)
    xs, ys, z = xs[valid], ys[valid], z[valid]
    x = (xs + 0.5 - K[0, 2]) / K[0, 0] * z
    y = (ys + 0.5 - K[1, 2]) / K[1, 1] * z
    p_cam = np.stack([x, y, z], axis=-1)
    pts = p_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = None
    if rgb is not None:
        cols = np.asarray(rgb)[ys, xs]
    return pts.astype(np.float32), cols


def invdepth_to_points(invdepth: np.ndarray, K: np.ndarray, c2w: np.ndarray,
                       rgb: Optional[np.ndarray] = None,
                       stride: int = 4, max_depth: float = np.inf):
    """Back-project an inverse-depth map (`depth2pc_partition`,
    `depth2pc.py:96-166`: the street-camera point lift used by the chunk
    partitioner)."""
    inv = np.asarray(invdepth, dtype=np.float64)
    depth = np.where(inv > 1e-9, 1.0 / np.clip(inv, 1e-9, None), 0.0)
    return depth_to_points(depth, K, c2w, rgb=rgb, stride=stride,
                           max_depth=max_depth)


def fit_invdepth_scale(mono_invdepth: np.ndarray,
                       sparse_points2d: np.ndarray,
                       sparse_depth: np.ndarray) -> dict:
    """Fit `scale`/`offset` so that `mono_invdepth * scale + offset`
    matches 1/sparse_depth, via medians and MADs
    (`make_depth_scale.py:60-76`; consumed by `Camera`'s
    `invdepth * scale + offset`, `scene/cameras.py:62-68`).

    mono_invdepth (H, W); sparse_points2d (M, 2) pixel coords of COLMAP
    track observations in this image; sparse_depth (M,) camera z."""
    H, W = mono_invdepth.shape
    u = np.clip(np.round(sparse_points2d[:, 0]).astype(np.int64), 0, W - 1)
    v = np.clip(np.round(sparse_points2d[:, 1]).astype(np.int64), 0, H - 1)
    ok = sparse_depth > 1e-6
    if ok.sum() < 5:
        return {"scale": 0.0, "offset": 0.0, "n": int(ok.sum())}
    inv_sparse = 1.0 / sparse_depth[ok]
    mono = mono_invdepth[v[ok], u[ok]]

    t_colmap = np.median(inv_sparse)
    s_colmap = np.mean(np.abs(inv_sparse - t_colmap))
    t_mono = np.median(mono)
    s_mono = np.mean(np.abs(mono - t_mono))
    scale = s_colmap / max(s_mono, 1e-12)
    offset = t_colmap - t_mono * scale
    return {"scale": float(scale), "offset": float(offset),
            "n": int(ok.sum())}


def sparse_depths_for_image(xys: np.ndarray, point3d_ids: np.ndarray,
                            points3d: np.ndarray, ids: np.ndarray,
                            viewmat: np.ndarray):
    """COLMAP image observations -> (points2d, depth) pairs for
    `fit_invdepth_scale` (`make_depth_scale.py:23-58` semantics)."""
    id_to_row = {int(pid): i for i, pid in enumerate(ids)}
    rows, keep = [], []
    for i, pid in enumerate(point3d_ids):
        r = id_to_row.get(int(pid), -1)
        if r >= 0:
            rows.append(r)
            keep.append(i)
    if not rows:
        return np.zeros((0, 2)), np.zeros((0,))
    pts = points3d[np.asarray(rows)]
    p_cam = pts @ viewmat[:3, :3].T + viewmat[:3, 3]
    return xys[np.asarray(keep)], p_cam[:, 2]
