"""Dataset readers: COLMAP / Blender / City (MatrixCity) / UCGS.

A copy of `horizongs_tpu/data/readers.py` (this package imports nothing of
the JAX package): the readers are numpy and PIL, so both packages read a
dataset into the same `SceneInfo`. The JAX package's notes follow.

Port of the *semantics* of `scene/dataset_readers.py` (691 LoC): the same
four `sceneLoadTypeCallbacks`, the same train/test splits (llffhold),
aerial/street classification, depth handling, recentering/scaling, and
nerf++ normalization radius. Differences by design:
  * camera infos are lazy (paths + metadata); pixels load at camera-list
    build time (`data/camera_build.py`) instead of reader time;
  * EXR depth requires imageio; `.npy` depth maps are also accepted;
  * UCGS's hardcoded aerial index (352) and dataset subdirectories are
    configurable (reference hardcodes them, `dataset_readers.py:318,
    626-632` — a quirk SURVEY.md flags to keep as config).
"""
from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np

from horizongs_tpu_torch.core.cameras import (
    focal_to_fov,
    fov_to_focal,
    world_to_view,
)
from horizongs_tpu_torch.data.colmap import (
    qvec2rotmat,
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
    read_points3D_binary,
    read_points3D_text,
)
from horizongs_tpu_torch.io.plyio import read_points_ply, write_points_ply


@dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray            # c2w rotation (stored transposed, COLMAP style)
    T: np.ndarray            # w2c translation
    fovx: float
    fovy: float
    cx: float
    cy: float
    width: int
    height: int
    image_path: str
    image_name: str
    mask_path: Optional[str] = None
    depth_path: Optional[str] = None
    depth_params: Optional[dict] = None
    depth_scale: float = 1.0  # divisor applied to raw depth values
    # evaluation subset tag (UCGS robustness splits: "heldout" /
    # "shift_0.1m" / "shift_0.1m_rot_5deg"); empty for ordinary cameras
    subset: str = ""


@dataclass
class SceneInfo:
    point_cloud: BasicPointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """`getNerfppNorm` (`dataset_readers.py:60-81`)."""
    centers = []
    for cam in cam_infos:
        W2C = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(W2C)[:3, 3])
    centers = np.stack(centers, axis=0)
    avg = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - avg, axis=1).max()
    return {"translate": -avg, "radius": float(diagonal * 1.1)}


def _classify(image_path: str) -> Optional[str]:
    if "aerial" in image_path:
        return "aerial"
    if "street" in image_path:
        return "street"
    return None


def _filter_by_type(infos, add_aerial, add_street, strict=False):
    out = []
    for c in infos:
        t = _classify(c.image_path)
        if t == "aerial" and not add_aerial:
            continue
        if t == "street" and not add_street:
            continue
        if t is None and strict:
            raise ValueError(f"Unknown image type: {c.image_path}")
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------------

def _read_colmap_model(sparse_dir: str):
    try:
        extr = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        intr = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
    except FileNotFoundError:
        extr = read_images_text(os.path.join(sparse_dir, "images.txt"))
        intr = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
    return extr, intr


def _colmap_cam_infos(extr, intr, images_dir, masks_dir=None, depths_dir=None,
                      depths_params=None, basename_only=False):
    infos = []
    for key in extr:
        e = extr[key]
        i = intr[e.camera_id]
        R = qvec2rotmat(e.qvec).T
        T = np.array(e.tvec)
        if i.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = i.params[0]
            cx, cy = i.params[1], i.params[2]
        elif i.model == "PINHOLE":
            fx, fy = i.params[0], i.params[1]
            cx, cy = i.params[2], i.params[3]
        else:
            raise AssertionError(
                "Colmap camera model not handled: only PINHOLE / "
                "SIMPLE_PINHOLE supported")
        name = os.path.basename(e.name) if basename_only else e.name
        image_path = os.path.join(images_dir, name)
        if not os.path.exists(image_path):
            continue
        stem = os.path.basename(image_path).split(".")[0]
        dp = None
        if depths_params is not None:
            dp = depths_params.get(e.name.split(".")[0])
        depth_path = None
        if depths_dir is not None:
            cand = os.path.join(depths_dir, e.name.replace(".JPG", ".png"))
            if os.path.exists(cand):
                depth_path = cand
        mask_path = None
        if masks_dir is not None:
            cand = os.path.join(masks_dir, e.name)
            if os.path.exists(cand):
                mask_path = cand
        infos.append(CameraInfo(
            uid=i.id, R=R, T=T,
            fovx=focal_to_fov(fx, i.width), fovy=focal_to_fov(fy, i.height),
            cx=cx, cy=cy, width=i.width, height=i.height,
            image_path=image_path, image_name=stem,
            mask_path=mask_path, depth_path=depth_path, depth_params=dp,
            depth_scale=float(2 ** 16)))
    return sorted(infos, key=lambda c: c.image_path)


def read_colmap_scene(path, eval=True, images="images", add_mask=False,
                      add_depth=False, add_aerial=True, add_street=True,
                      llffhold=32, **_):
    """`readColmapSceneInfo` (`dataset_readers.py:468-534`)."""
    extr, intr = _read_colmap_model(os.path.join(path, "sparse/0"))
    depths_params = None
    if add_depth:
        with open(os.path.join(path, "sparse/0", "depth_params.json")) as f:
            depths_params = json.load(f)
        scales = np.array([depths_params[k]["scale"] for k in depths_params])
        med = np.median(scales[scales > 0]) if (scales > 0).sum() else 0
        for k in depths_params:
            depths_params[k]["med_scale"] = med
    infos = _colmap_cam_infos(
        extr, intr, os.path.join(path, images),
        masks_dir=os.path.join(path, "masks") if add_mask else None,
        depths_dir=os.path.join(path, "depths") if add_depth else None,
        depths_params=depths_params)
    infos = _filter_by_type(infos, add_aerial, add_street)

    if eval:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = read_points3D_binary(
                os.path.join(path, "sparse/0/points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = read_points3D_text(
                os.path.join(path, "sparse/0/points3D.txt"))
        write_points_ply(ply_path, xyz, rgb)
    pts, cols, norms = read_points_ply(ply_path)
    pcd = BasicPointCloud(pts, cols, norms)
    return SceneInfo(pcd, train, test, nerfpp_norm(train or infos), ply_path)


# ---------------------------------------------------------------------------
# Blender transforms / City (MatrixCity)
# ---------------------------------------------------------------------------

def _transforms_cam_infos(path, transforms_file, add_mask, add_depth,
                          center, scale):
    """`readCamerasFromTransforms` (`dataset_readers.py:335-466`), lazy."""
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    infos = []
    for idx, frame in enumerate(contents["frames"]):
        image_path = os.path.join(path, frame["file_path"])
        if not os.path.exists(image_path):
            raise ValueError(f"Image {image_path} does not exist!")
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 3] -= np.asarray(center)
        c2w[:3, 3] /= scale
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        if "small_city" in path:
            c2w[-1, -1] = 1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        # image size needed for fov: read lazily from header via PIL
        from PIL import Image
        with Image.open(image_path) as im:
            w, h = im.size
        if fovx is not None:
            fovy = focal_to_fov(fov_to_focal(fovx, w), h)
            fx_deg, fy_deg = fovx, fovy
            cx, cy = w / 2, h / 2
        else:
            fx_deg = focal_to_fov(frame["fl_x"], w)
            fy_deg = focal_to_fov(frame["fl_y"], h)
            cx, cy = frame["cx"], frame["cy"]

        mask_path = None
        if add_mask and "mask_path" in frame:
            mask_path = os.path.join(path, frame["mask_path"])
        depth_path = None
        if add_depth and "depth_path" in frame:
            depth_path = os.path.join(path, frame["depth_path"])
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fx_deg, fovy=fy_deg, cx=cx, cy=cy,
            width=w, height=h, image_path=image_path,
            image_name=os.path.splitext(os.path.basename(image_path))[0],
            mask_path=mask_path, depth_path=depth_path,
            depth_params={"scale": (6 / scale)},
            depth_scale=10000.0 * scale))
    return sorted(infos, key=lambda c: c.image_path)


def read_blender_scene(path, eval=True, add_mask=False, add_depth=False,
                       add_aerial=True, add_street=True,
                       center=(0, 0, 0), scale=1.0, **_):
    """`readNerfSyntheticInfo` (`dataset_readers.py:536-572`)."""
    train = _transforms_cam_infos(path, "transforms_train.json", add_mask,
                                  add_depth, center, scale)
    test = _transforms_cam_infos(path, "transforms_test.json", add_mask,
                                 add_depth, center, scale)
    train = _filter_by_type(train, add_aerial, add_street, strict=True)
    test = _filter_by_type(test, add_aerial, add_street, strict=True)
    if not eval:
        train = train + test
        test = []
    plys = glob.glob(os.path.join(path, "*.ply"))
    if not plys:
        ply_path = os.path.join(path, "points3d.ply")
        xyz = np.random.random((10_000, 3)) * 2.6 - 1.3
        colors = np.random.random((10_000, 3))
        write_points_ply(ply_path, xyz, colors)
        pcd = BasicPointCloud(xyz.astype(np.float32),
                              colors.astype(np.float32),
                              np.zeros_like(xyz, dtype=np.float32))
    else:
        ply_path = plys[0]
        pts, cols, norms = read_points_ply(ply_path)
        pcd = BasicPointCloud(pts, cols, norms)
    pcd.points = (pcd.points - np.asarray(center, dtype=np.float32)) / scale
    return SceneInfo(pcd, train, test, nerfpp_norm(train), ply_path)


def read_city_scene(path, eval=True, add_mask=False, add_depth=False,
                    add_aerial=True, add_street=True, center=(0, 0, 0),
                    scale=1.0, llffhold=32, **_):
    """`readCityInfo` (`dataset_readers.py:574-620`): MatrixCity-style
    transforms.json + tie-point PLY (LAS ingest gated on laspy)."""
    json_path = os.path.basename(
        glob.glob(os.path.join(path, "transforms.json"))[0])
    plys = glob.glob(os.path.join(path, "*.ply"))
    if plys:
        ply_path = plys[0]
        pts, cols, norms = read_points_ply(ply_path)
        pcd = BasicPointCloud(pts, cols, norms)
    else:
        ply_path = os.path.join(path, "points3d.ply")
        las_paths = sorted(glob.glob(os.path.join(path, "LAS/*.las")))
        if not las_paths:
            raise ValueError("must have tiepoints!")
        try:
            import laspy
        except ImportError as e:
            raise ImportError("LAS ingest requires laspy") from e
        all_pts, all_cols = [], []
        for lp in las_paths:
            las = laspy.read(lp)
            all_pts.append(np.vstack((las.x, las.y, las.z)).T)
            try:
                all_cols.append(np.vstack((las.red, las.green, las.blue)).T)
            except Exception:
                all_cols.append(np.random.rand(all_pts[-1].shape[0], 3))
        pts = np.vstack(all_pts).astype(np.float32)
        cols = np.vstack(all_cols).astype(np.float32)
        write_points_ply(ply_path, pts, cols / max(cols.max(), 1.0))
        pcd = BasicPointCloud(pts, cols, np.zeros_like(pts))
    pcd.points = (pcd.points - np.asarray(center, dtype=np.float32)) / scale

    infos = _transforms_cam_infos(path, json_path, add_mask, add_depth,
                                  center, scale)
    infos = _filter_by_type(infos, add_aerial, add_street, strict=True)
    if eval:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    return SceneInfo(pcd, train, test, nerfpp_norm(train), ply_path)


# ---------------------------------------------------------------------------
# UCGS (aerial+ground robustness benchmark)
# ---------------------------------------------------------------------------

UCGS_SUBDIRS = {
    "NYC": ("traina20g1.5", "test1.6", "test1.6d5"),
    "SF": ("traina20g1.8", "test1.9", "test1.9d5"),
}
UCGS_AERIAL_MIN_INDEX = 352   # reference hardcode (dataset_readers.py:318)


def read_ucgs_scene(path, images="images", add_aerial=True, add_street=True,
                    aerial_min_index=UCGS_AERIAL_MIN_INDEX, **_):
    """`readUCGSInfo` (`dataset_readers.py:623-685`): three COLMAP subsets
    (held-out / +0.1m / +0.1m+5°)."""
    for key, dirs in UCGS_SUBDIRS.items():
        if key in path:
            train_dir, test_pos_dir, test_rot_dir = dirs
            break
    else:
        raise ValueError(f"UCGS dataset not recognized from path: {path}")

    def load(sub):
        extr, intr = _read_colmap_model(os.path.join(path, sub, "sparse/0"))
        infos = _colmap_cam_infos(extr, intr, os.path.join(path, sub, images),
                                  basename_only=True)
        out = []
        for c in infos:
            is_aerial = ("train" in c.image_name and
                         int(re.findall(r"\d+", c.image_name)[0]) >= aerial_min_index)
            if is_aerial and not add_aerial:
                continue
            if not is_aerial and not add_street:
                continue
            out.append(c)
        return out

    cam20 = load(train_dir)
    cam_pos = load(test_pos_dir)
    cam_rot = load(test_rot_dir)
    train = [c for c in cam20 if "eval" not in c.image_name]
    # the three robustness splits keep their identity so evaluation can
    # report them separately (reference slices them by index at
    # `train.py:542-591`; we tag instead of relying on ordering)
    test = (
        [replace(c, subset="heldout")
         for c in cam20 if "eval" in c.image_name]
        + [replace(c, subset="shift_0.1m")
           for c in cam_pos if "eval" in c.image_name]
        + [replace(c, subset="shift_0.1m_rot_5deg")
           for c in cam_rot if "eval" in c.image_name])

    ply_path = os.path.join(path, train_dir, "sparse/0/points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = read_points3D_binary(
                os.path.join(path, train_dir, "sparse/0/points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = read_points3D_text(
                os.path.join(path, train_dir, "sparse/0/points3D.txt"))
        write_points_ply(ply_path, xyz, rgb)
    pts, cols, norms = read_points_ply(ply_path)
    pcd = BasicPointCloud(pts, cols, norms)
    return SceneInfo(pcd, train, test, nerfpp_norm(train), ply_path)


scene_load_callbacks = {
    "colmap": read_colmap_scene,
    "blender": read_blender_scene,
    "city": read_city_scene,
    "ucgs": read_ucgs_scene,
}
