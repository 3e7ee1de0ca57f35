"""Synthetic scenes for tests and the chip smoke run (no dataset needed).

`random_gaussians` is numpy and gives the same arrays as the JAX package's
`data/synthetic.py` for the same seed; the cameras are built the same way
and handed over as tensors; `write_synthetic_blender_dataset` writes the
hermetic dataset the synthetic configs train on.
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


def write_synthetic_blender_dataset(path: str, n_train: int = 6,
                                    n_test: int = 2, width: int = 64,
                                    height: int = 64, n_gauss: int = 40,
                                    seed: int = 0, with_street: bool = True,
                                    device: DeviceLike = None) -> dict:
    """Write a small Blender-format dataset (transforms_*.json, RGBA PNGs
    and points3d.ply) rendered from a known gaussian cloud by the dense
    oracle, on `device` (the card by default), so that the whole CLI runs
    with no download. The JAX package's writer: the same cameras, files and
    cloud; a frame's 8-bit PNG may differ from the JAX package's by one
    level where the two renders differ in the last place. Returns the
    cloud as numpy arrays."""
    import json
    import os

    import torch
    from PIL import Image

    from horizongs_tpu_torch.device import disable_tf32, resolve_device
    from horizongs_tpu_torch.io.plyio import write_points_ply
    from horizongs_tpu_torch.ops.reference import render_dense_3dgs

    dev = resolve_device(device)
    disable_tf32()
    os.makedirs(os.path.join(path, "aerial"), exist_ok=True)
    if with_street:
        os.makedirs(os.path.join(path, "street"), exist_ok=True)

    g_np = random_gaussians(n_gauss, seed=seed, extent=0.7,
                            scale_range=(0.08, 0.2))
    g = {k: torch.from_numpy(v).to(dev) for k, v in g_np.items()}
    bg = torch.zeros(3, device=dev)
    fovx = math.radians(60.0)

    def frames_for(cams, subdir, prefix):
        frames = []
        for i, cam in enumerate(cams):
            with torch.no_grad():
                render, alphas, _ = render_dense_3dgs(
                    g["means"], g["quats"], g["scales"], g["opacities"],
                    g["colors"], cam.viewmat, cam.K, width, height, bg)
            rgba = np.concatenate([
                np.clip(render.cpu().numpy(), 0, 1),
                np.clip(alphas.cpu().numpy(), 0, 1)], axis=-1)
            rel = f"{subdir}/{prefix}_{i:03d}.png"
            Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
                os.path.join(path, rel))
            c2w = np.linalg.inv(cam.viewmat.cpu().numpy().astype(np.float64))
            c2w[:3, 1:3] *= -1          # COLMAP -> Blender axes
            frames.append({"file_path": rel,
                           "transform_matrix": c2w.tolist()})
        return frames

    n_aerial = n_train if not with_street else max(n_train * 2 // 3, 1)
    n_street = n_train - n_aerial if with_street else 0
    aerial = orbit_cameras(n_aerial, radius=4.0, height_z=-2.5,
                           width=width, height=height, device=dev)
    street = orbit_cameras(max(n_street, 1), radius=3.0, height_z=0.3,
                           width=width, height=height, device=dev)[:n_street]
    test = orbit_cameras(max(n_test, 1), radius=3.8, height_z=-1.8,
                         width=width, height=height, device=dev)[:n_test]

    train_frames = frames_for(aerial, "aerial", "a")
    if n_street:
        train_frames += frames_for(street, "street", "s")
    test_frames = frames_for(test, "aerial", "t")

    for name, frames in (("transforms_train.json", train_frames),
                         ("transforms_test.json", test_frames)):
        with open(os.path.join(path, name), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)

    write_points_ply(os.path.join(path, "points3d.ply"), g_np["means"],
                     g_np["colors"])
    return g_np
