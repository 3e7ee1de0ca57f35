"""Camera construction: resolution policy, pixel loading, mask/depth prep.

The JAX package's `data/camera_build.py` (a port of
`utils/camera_utils.py:26-90` + `scene/cameras.py:20-100`), with the same
numpy arithmetic; the camera's matrices and supervision become tensors on
the requested device (the trainer's: a 512x512 view takes 4 MB there):
  * resolution policy: -1 auto-downscales >1600px-wide images to 1.6K;
    1/2/4/8 divide; other values set the target width
  * aerial/street typing: UCGS by image index, others by path substring
  * RGBA alpha -> alpha_mask (or an explicit mask file)
  * depth: colmap mono-depth is inverse depth rescaled by per-image
    scale/offset; blender/city depth is metric (EXR/png/npy), inverted,
    with the "sky" trick: pixels deeper than the midrange get masked when
    the dynamic range exceeds 100x (`cameras.py:70-76`)

JPEG/PNG images decode and resize through the native C++ loader
(`horizongs_tpu_torch.native`, the JAX package's `native/` source) when it
builds, as the JAX package's loader does, so both train on the same
pixels; other formats, and every image when the library is unavailable,
go through PIL.
"""
from __future__ import annotations

import os
import re
from typing import List

import numpy as np
import torch

from horizongs_tpu_torch.core.cameras import (
    Camera,
    fov_to_focal,
    world_to_view,
)
from horizongs_tpu_torch.data.readers import CameraInfo
from horizongs_tpu_torch.device import DeviceLike, resolve_device

_WARNED = False


def _load_image(path: str, resolution) -> np.ndarray:
    """Decode + resize + normalize -> (H, W, C) float32, C the file's
    channel count (the alpha handling keys on it): the native loader for
    `NATIVE_FORMATS` when it is available, else PIL."""
    from horizongs_tpu_torch import native
    if path.endswith(native.NATIVE_FORMATS) and native.available():
        arr = native.load_image_rgba(path, resolution[0], resolution[1])
        _, _, c = native.image_info(path)
        return (arr[..., :4] if c in (2, 4) else arr[..., :3] if c == 3
                else arr[..., :1])
    from PIL import Image
    with Image.open(path) as im:
        im = im.resize(resolution)
        arr = np.asarray(im).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def _load_depth(path: str, resolution) -> np.ndarray:
    if path.endswith(".npy"):
        depth = np.load(path).astype(np.float32)
    elif path.endswith(".exr"):
        import imageio.v3 as iio
        depth = np.asarray(iio.imread(path)).astype(np.float32)
    else:
        from PIL import Image
        with Image.open(path) as im:
            depth = np.asarray(im).astype(np.float32)
    if depth.ndim == 3:
        depth = depth[..., 0]
    # nearest resize to the target resolution
    H, W = depth.shape
    tw, th = resolution
    yi = np.clip((np.arange(th) * H / th).astype(int), 0, H - 1)
    xi = np.clip((np.arange(tw) * W / tw).astype(int), 0, W - 1)
    return depth[yi][:, xi]


def classify_image_type(info: CameraInfo, data_format: str,
                        aerial_min_index: int = 352) -> str:
    """`loadCam` typing rules (`camera_utils.py:48-62`)."""
    if data_format == "ucgs":
        if "train" in info.image_name:
            idx = int(re.findall(r"\d+", info.image_name)[0])
            return "aerial" if idx >= aerial_min_index else "street"
        return "street"
    if "aerial" in info.image_path:
        return "aerial"
    if "street" in info.image_path:
        return "street"
    raise ValueError(f"Unknown image type: {info.image_path}")


def compute_resolution(orig_w: int, orig_h: int, resolution,
                       resolution_scale: float):
    """`loadCam` resolution policy (`camera_utils.py:29-46`)."""
    global _WARNED
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        if orig_w > 1600:
            if not _WARNED:
                print("[ INFO ] large input images (>1.6K width), "
                      "rescaling to 1.6K; pass resolution=1 to disable")
                _WARNED = True
            global_down = orig_w / 1600
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution
    s = float(global_down) * float(resolution_scale)
    return int(orig_w / s), int(orig_h / s)


def load_camera(args, uid: int, info: CameraInfo,
                resolution_scale: float = 1.0,
                device: DeviceLike = None) -> Camera:
    dev = resolve_device(device)
    resolution = compute_resolution(info.width, info.height,
                                    getattr(args, "resolution", -1),
                                    resolution_scale)
    image_type = classify_image_type(info, getattr(args, "data_format", ""))

    rgba = _load_image(info.image_path, resolution)
    image = np.clip(rgba[..., :3], 0.0, 1.0)
    if info.mask_path is not None:
        alpha = _load_image(info.mask_path, resolution)[..., :1]
    elif rgba.shape[-1] == 4:
        alpha = rgba[..., 3:4]
    else:
        alpha = np.ones_like(image[..., :1])

    invdepth = None
    depth_mask = None
    fmt = getattr(args, "data_format", "")
    if info.depth_path is not None and os.path.exists(info.depth_path):
        raw = _load_depth(info.depth_path, resolution)
        if fmt == "colmap":
            dp = info.depth_params or {}
            inv = ((raw / info.depth_scale) * dp.get("scale", 1.0)
                   + dp.get("offset", 0.0))
            inv = np.where(inv < 0, 0.0, inv)
            invdepth = inv[..., None]
        else:  # blender / city: metric depth
            depth = raw / info.depth_scale
            dmax, dmin = depth.max(), max(depth.min(), 1e-12)
            if rgba.shape[-1] == 4 or info.mask_path is not None:
                if dmax / dmin > 100:
                    alpha = alpha * (depth < 0.5 * (dmax + dmin))[..., None]
            invdepth = (1.0 / np.clip(depth, 1e-12, None))[..., None]
        depth_mask = alpha.copy()

    # intrinsics at the render resolution (principal point rescaled,
    # focals from fov, `cameras.py:96-99`)
    w, h = resolution
    fx = fov_to_focal(info.fovx, w)
    fy = fov_to_focal(info.fovy, h)
    cx = info.cx * w / info.width
    cy = info.cy * h / info.height
    viewmat = world_to_view(info.R, info.T)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    cam_center = np.linalg.inv(viewmat)[:3, 3]

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    return Camera(
        viewmat=t(viewmat), K=t(K), width=w, height=h,
        cam_center=t(cam_center), uid=uid,
        resolution_scale=resolution_scale, image=t(image),
        alpha_mask=t(alpha), invdepth=t(invdepth),
        depth_mask=t(depth_mask), image_type=image_type,
        subset=info.subset)


def camera_list(infos: List[CameraInfo], args,
                resolution_scale: float = 1.0, max_workers: int = 8,
                device: DeviceLike = None) -> List[Camera]:
    """Thread-pool camera construction (the reference's
    `cameraList_from_camInfos` pool, `utils/camera_utils.py:69-90`); the
    native loader and PIL release the GIL while they decode."""
    dev = resolve_device(device)
    if len(infos) <= 1 or max_workers <= 1:
        return [load_camera(args, i, info, resolution_scale, dev)
                for i, info in enumerate(infos)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = [ex.submit(load_camera, args, i, info, resolution_scale, dev)
                for i, info in enumerate(infos)]
        return [f.result() for f in futs]


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """`camera_to_JSON` (`camera_utils.py:92-112`)."""
    W2C = np.linalg.inv(world_to_view(info.R, info.T))
    return {
        "id": idx, "img_name": info.image_name,
        "width": info.width, "height": info.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov_to_focal(info.fovy, info.height),
        "fx": fov_to_focal(info.fovx, info.width),
    }
