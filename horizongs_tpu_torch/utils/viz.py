"""Depth / normal / error visualization helpers: a copy of
`horizongs_tpu/utils/viz.py` (this package imports nothing of the JAX
package).

Equivalents of the reference's `utils/general_utils.py:21-51`
(`vis_depth` turbo-colormap depth, `vis_surface_normal`) and
`utils/visualize_utils.py` (jet/label maps) — numpy only, no matplotlib.
"""
from __future__ import annotations

import numpy as np

# Google Turbo colormap, 4th-degree polynomial fit per channel
# (Mikhailov 2019). Input t in [0, 1].
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def turbo_colormap(t: np.ndarray) -> np.ndarray:
    """t (…,) in [0,1] -> RGB (…, 3) in [0,1]."""
    t = np.clip(np.asarray(t, dtype=np.float64), 0.0, 1.0)
    powers = np.stack([t ** i for i in range(6)], axis=-1)
    rgb = np.stack([powers @ _TURBO_R, powers @ _TURBO_G, powers @ _TURBO_B],
                   axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def vis_depth(depth: np.ndarray, near_q: float = 0.01,
              far_q: float = 0.99) -> np.ndarray:
    """Depth map (H, W) -> turbo RGB (H, W, 3); invalid (<=0) pixels black.

    Range normalization by quantiles of the valid depths, matching the
    spirit of `vis_depth` (`utils/general_utils.py:21-40`)."""
    depth = np.asarray(depth)
    valid = depth > 0
    if valid.any():
        lo = np.quantile(depth[valid], near_q)
        hi = np.quantile(depth[valid], far_q)
        t = (depth - lo) / max(hi - lo, 1e-12)
    else:
        t = np.zeros_like(depth)
    rgb = turbo_colormap(1.0 - t)            # near = red end
    return np.where(valid[..., None], rgb, 0.0)


def vis_normal(normal: np.ndarray) -> np.ndarray:
    """Camera-space normals (H, W, 3) in [-1,1] -> RGB in [0,1]
    (`vis_surface_normal`, `utils/general_utils.py:42-51`)."""
    return np.clip(np.asarray(normal) * 0.5 + 0.5, 0.0, 1.0)


def image_grid(images, cols: int = 2, pad: int = 2) -> np.ndarray:
    """Stack HWC [0,1] images into a grid (train-time vis,
    `train.py:230-254`)."""
    images = [np.asarray(im) for im in images]
    H = max(im.shape[0] for im in images)
    W = max(im.shape[1] for im in images)
    rows = -(-len(images) // cols)
    grid = np.ones((rows * (H + pad) - pad, cols * (W + pad) - pad, 3))
    for i, im in enumerate(images):
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=-1)
        r, c = divmod(i, cols)
        grid[r * (H + pad):r * (H + pad) + im.shape[0],
             c * (W + pad):c * (W + pad) + im.shape[1]] = im[..., :3]
    return grid
