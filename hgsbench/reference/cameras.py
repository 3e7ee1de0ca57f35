# Frozen copy of horizongs_tpu_torch/core/cameras.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""Camera model: pinhole intrinsics + world-to-camera extrinsics.

COLMAP-style R/t convention (Horizon-GS `graphics_utils.py`): `R` is
stored transposed (camera-to-world rotation) and `t` is the world-to-camera
translation. The rasterizer consumes a 4x4 world-to-camera `viewmat`
(`x_cam = viewmat @ x_world`) and a 3x3 intrinsics matrix `K`. The matrices
are built in numpy, exactly as the JAX package builds them, and then become
tensors on the requested device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from hgsbench.reference.device import DeviceLike, resolve_device


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 float32 world-to-camera matrix (`getWorld2View2` without the
    recentering: the dataset readers recenter the poses themselves)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


class Camera(NamedTuple):
    """A render-ready camera: float32 tensors on one device, static dims.

    `viewmat` is world->camera (4, 4), `K` the intrinsics (3, 3) at the
    render resolution, `cam_center` the camera origin in world space (for
    view directions and the LOD distance rule). A camera loaded from a
    dataset (`data/camera_build.py`) also carries its supervision: the
    image (H, W, 3), the alpha mask (H, W, 1), and where the dataset has
    depth the inverse depth and its mask (H, W, 1); None when absent."""
    viewmat: torch.Tensor
    K: torch.Tensor
    width: int
    height: int
    cam_center: torch.Tensor
    uid: int = 0                  # camera index (appearance embedding row)
    resolution_scale: float = 1.0
    image: Optional[torch.Tensor] = None
    alpha_mask: Optional[torch.Tensor] = None
    invdepth: Optional[torch.Tensor] = None
    depth_mask: Optional[torch.Tensor] = None
    image_type: str = "aerial"    # "aerial" | "street"
    subset: str = ""              # evaluation subset tag (UCGS splits)


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, uid: int = 0,
                resolution_scale: float = 1.0,
                device: DeviceLike = None) -> Camera:
    """Camera from COLMAP-convention extrinsics + fov intrinsics."""
    dev = resolve_device(device)
    viewmat = world_to_view(R, t)
    cam_center = np.linalg.inv(viewmat)[:3, 3]
    fx = fov_to_focal(fovx, width)
    fy = fov_to_focal(fovy, height)
    K = np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]],
                 dtype=np.float32)
    return Camera(
        viewmat=torch.from_numpy(viewmat).to(dev),
        K=torch.from_numpy(K).to(dev),
        width=int(width),
        height=int(height),
        cam_center=torch.from_numpy(
            np.asarray(cam_center, dtype=np.float32)).to(dev),
        uid=uid, resolution_scale=resolution_scale,
    )


def camera_from_matrices(ref: Camera, viewmat: np.ndarray,
                         uid: int = 0) -> Camera:
    """A novel-view camera with `ref`'s intrinsics and size, on `ref`'s
    device (fly-through paths, reference `render_utils.py:160-181`):
    `viewmat` (4, 4) float32 world->camera, its centre from its inverse,
    no supervision."""
    viewmat = np.asarray(viewmat, dtype=np.float32)
    cam_center = np.linalg.inv(viewmat)[:3, 3].astype(np.float32)
    dev = ref.viewmat.device
    return ref._replace(viewmat=torch.from_numpy(viewmat).to(dev),
                        cam_center=torch.from_numpy(cam_center).to(dev),
                        image=None, alpha_mask=None, invdepth=None,
                        depth_mask=None, uid=uid)
