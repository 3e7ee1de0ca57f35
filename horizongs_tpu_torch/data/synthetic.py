"""Synthetic scenes for tests and the chip smoke run (no dataset needed).

`random_gaussians` is numpy and gives the same arrays as the JAX package's
`data/synthetic.py` for the same seed; the cameras are built the same way
and handed over as tensors.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from horizongs_tpu_torch.core.cameras import Camera, make_camera
from horizongs_tpu_torch.device import DeviceLike


def random_gaussians(n: int, seed: int = 0, extent: float = 1.0,
                     scale_range: Tuple[float, float] = (0.01, 0.05),
                     center: Tuple[float, float, float] = (0.0, 0.0, 0.0)):
    """Random gaussian cloud in a cube of half-size `extent` around `center`.

    Returns a dict of numpy arrays: means (n,3), quats (n,4) normalized
    wxyz, scales (n,3), opacities (n,), colors (n,3) in [0,1]."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, size=(n, 3)) + np.asarray(center)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(*scale_range, size=(n, 3))
    opacities = rng.uniform(0.3, 0.95, size=(n,))
    colors = rng.uniform(0.0, 1.0, size=(n, 3))
    return {
        "means": means.astype(np.float32),
        "quats": quats.astype(np.float32),
        "scales": scales.astype(np.float32),
        "opacities": opacities.astype(np.float32),
        "colors": colors.astype(np.float32),
    }


def lookat_camera(width: int = 128, height: int = 128,
                  eye: Tuple[float, float, float] = (0.0, 0.0, -4.0),
                  target: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                  up: Tuple[float, float, float] = (0.0, -1.0, 0.0),
                  fovx: float = math.radians(60.0), uid: int = 0,
                  device: DeviceLike = None) -> Camera:
    """Camera at `eye` looking at `target` (OpenCV convention: +z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)  # columns = camera axes
    t_w2c = -R_c2w.T @ eye
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(R=R_c2w, t=t_w2c, fovx=fovx, fovy=fovy,
                       width=width, height=height, uid=uid, device=device)


def orbit_cameras(n_cams: int, radius: float = 4.0, height_z: float = -1.5,
                  width: int = 128, height: int = 128,
                  device: DeviceLike = None):
    """Ring of cameras orbiting the origin (aerial-ish if height_z < 0)."""
    cams = []
    for i in range(n_cams):
        theta = 2 * math.pi * i / n_cams
        eye = (radius * math.cos(theta), radius * math.sin(theta), height_z)
        cams.append(lookat_camera(width=width, height=height, eye=eye,
                                  uid=i, device=device))
    return cams
