"""Novel-view camera paths + video assembly.

A copy of the JAX package's `utils/render_paths.py` (the reference's
`utils/render_utils.py:28-254`): PCA pose alignment, focus-point
estimation, elliptical fly-through path generation, and video writing
(frame PNGs always; an mp4 too where `imageio` and its ffmpeg are
installed). The poses are host numpy in float64, as in the JAX package;
the cameras of a path go to the device of the cameras they were built
from.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from horizongs_tpu_torch.core.cameras import camera_from_matrices


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(lookdir: np.ndarray, up: np.ndarray,
               position: np.ndarray) -> np.ndarray:
    """c2w 3x4 from a look direction, up hint, and position."""
    vec2 = _normalize(lookdir)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def focus_point(poses: np.ndarray) -> np.ndarray:
    """Point minimizing distance to all camera optical axes
    (`focus_point_fn`, `render_utils.py:68-74`). poses (N, 3/4, 4) c2w."""
    directions = poses[:, :3, 2:3]
    origins = poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, (0, 2, 1))
    mt_m = np.transpose(m, (0, 2, 1)) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Align world axes with the principal components of the camera
    positions, recenter, scale into [-1, 1], keep +z up
    (`transform_poses_pca`, `render_utils.py:76-107`).

    poses (N, 3/4, 4) c2w -> (aligned poses (N, 3, 4), transform (4, 4))."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    rot = eigvec[:, inds].T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], axis=-1)
    poses_recentered = transform @ np.concatenate(
        [poses[:, :3, :], np.broadcast_to(
            np.array([0, 0, 0, 1.0]), (poses.shape[0], 1, 4))], axis=1)
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1]))[:3] @ np.concatenate(
            [transform, np.array([[0, 0, 0, 1.0]])], axis=0)
    scale = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    poses_recentered[:, :3, 3] *= scale
    transform = np.diag(np.array([scale] * 3 + [1.0])) @ np.concatenate(
        [transform, np.array([[0, 0, 0, 1.0]])], axis=0)
    return poses_recentered, transform


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0,
                          const_speed: bool = True) -> np.ndarray:
    """Elliptical orbit through the camera cloud, looking at the focus
    point (`generate_ellipse_path`, `render_utils.py:109-158`).

    poses (N, 3/4, 4) c2w -> path poses (n_frames, 3, 4)."""
    center = focus_point(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2]
                           * (np.cos(theta + 2 * np.pi * z_phase)
                              * 0.5 + 0.5)),
        ], axis=-1)

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    if const_speed:
        # resample so arc lengths are uniform
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        acc = np.concatenate([[0], np.cumsum(lengths)])
        acc /= acc[-1]
        theta = np.interp(np.linspace(0, 1, n_frames + 1), acc, theta)
        positions = get_positions(theta)
    positions = positions[:-1]

    avg_up = poses[:, :3, 1].mean(0)
    avg_up = avg_up / np.linalg.norm(avg_up)
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack([viewmatrix(p - center, up, p) for p in positions])


def generate_path_cameras(cameras, n_frames: int = 480):
    """Fly-through `Camera`s from the training cameras
    (`generate_path`, `render_utils.py:160-181`): PCA-align, build the
    ellipse in the aligned frame, map back to world."""
    c2ws = np.array([np.linalg.inv(cam.viewmat.cpu().numpy())
                     for cam in cameras])
    pose = c2ws[:, :3, :]
    pose_recenter, transform = transform_poses_pca(pose)
    new_poses = generate_ellipse_path(pose_recenter, n_frames=n_frames)
    new_poses = np.linalg.inv(transform) @ np.concatenate(
        [new_poses, np.broadcast_to(
            np.array([0, 0, 0, 1.0]), (new_poses.shape[0], 1, 4))], axis=1)

    ref = cameras[0]
    out = []
    for i, c2w in enumerate(new_poses):
        # `viewmatrix` builds NeRF-style poses (x right, y up, z backward)
        # and inv(transform) carries the PCA scale: orthonormalize and
        # flip to the COLMAP convention (+z forward) our Camera uses.
        R = np.asarray(c2w[:3, :3], dtype=np.float64)
        R = R / np.linalg.norm(R, axis=0, keepdims=True)
        R = R @ np.diag([1.0, -1.0, -1.0])
        c2w4 = np.eye(4)
        c2w4[:3, :3] = R
        c2w4[:3, 3] = c2w[:3, 3]
        viewmat = np.linalg.inv(c2w4)
        out.append(camera_from_matrices(
            ref, viewmat.astype(np.float32), uid=i))
    return out


def write_video(frames: List[np.ndarray], out_path: str, fps: int = 30,
                frames_dir: Optional[str] = None) -> str:
    """Write PNG frames (always) and an mp4 when imageio+ffmpeg exist
    (the reference uses mediapy, `render_utils.py:189-254`)."""
    from PIL import Image
    if frames_dir is None:
        frames_dir = os.path.splitext(out_path)[0] + "_frames"
    os.makedirs(frames_dir, exist_ok=True)
    for i, fr in enumerate(frames):
        arr = (np.clip(np.asarray(fr), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(frames_dir, f"{i:05d}.png"))
    try:
        import imageio.v2 as imageio
        with imageio.get_writer(out_path, fps=fps) as w:
            for fr in frames:
                w.append_data(
                    (np.clip(np.asarray(fr), 0, 1) * 255).astype(np.uint8))
        return out_path
    except Exception:
        return frames_dir
