"""COLMAP sparse-model parsers (.bin and .txt), self-contained numpy.

A copy of `horizongs_tpu/data/colmap.py` (this package imports nothing of
the JAX package), the equivalent of the reference's
`scene/colmap_loader.py`: cameras, images (extrinsics) and points3D
readers for undistorted pinhole models, and the binary writers that make
a model for the tests.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, mid, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[mid]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                int(el[0]), el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]))
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            ch = f.read(1)
            while ch != b"\x00":
                name += ch
                ch = f.read(1)
            (n2d,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * n2d), dtype=np.float64)
            data = data.reshape(n2d, 3) if n2d else data.reshape(0, 3)
            # layout is (x, y, id) with id as int64 bits in the double slot
            raw = data.tobytes()
            rec = np.frombuffer(raw, dtype=[("x", "<f8"), ("y", "<f8"),
                                            ("id", "<i8")])
            images[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"),
                np.stack([rec["x"], rec["y"]], axis=1) if n2d else np.zeros((0, 2)),
                rec["id"].copy())
    return images


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array([float(x) for x in el[1:5]])
        tvec = np.array([float(x) for x in el[5:8]])
        cam_id = int(el[8])
        name = el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(x) for x in pts]).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                                  xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def read_points3D_binary_full(path: str):
    """points3D.bin -> (ids (N,) int64, xyz (N,3), rgb (N,3) uint8,
    err (N,)).

    The native parser (`horizongs_tpu_torch.native`: one read and a
    pointer walk) when it is available, else a per-point struct walk with
    the same dtypes (the reference's `read_points3D_binary` costs tens of
    seconds on city-scale models)."""
    from horizongs_tpu_torch import native
    if native.available():
        return native.read_colmap_points3d(path)
    return _read_points3D_binary_walk(path)


def _read_points3D_binary_walk(path: str):
    """The per-point struct walk of `read_points3D_binary_full`."""
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        ids = np.empty(num, dtype=np.int64)
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        err = np.empty(num)
        for i in range(num):
            ids[i] = _read(f, 8, "Q")[0]
            xyz[i] = _read(f, 24, "ddd")
            rgb[i] = _read(f, 3, "BBB")
            err[i] = _read(f, 8, "d")[0]
            (tlen,) = _read(f, 8, "Q")
            f.seek(8 * tlen, os.SEEK_CUR)
    return ids, xyz, rgb.astype(np.uint8), err


def read_points3D_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    _, xyz, rgb, err = read_points3D_binary_full(path)
    return xyz, rgb.astype(np.float64), err


def read_points3D_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([float(x) for x in el[4:7]])
            err.append(float(el[7]))
    return np.array(xyz), np.array(rgb), np.array(err)


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, _ = MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = im.xys.shape[0]
            f.write(struct.pack("<Q", n))
            for j in range(n):
                f.write(struct.pack("<ddq", im.xys[j, 0], im.xys[j, 1],
                                    int(im.point3D_ids[j])))


def write_points3D_binary(xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray,
                          path: str) -> None:
    """Write a minimal points3D.bin (no tracks), the inverse of
    `read_points3D_binary` (reference `preprocess/read_write_model.py`
    write_points3D_binary semantics)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    rgb = np.asarray(rgb)
    if rgb.size and rgb.max() <= 1.5:
        rgb = rgb * 255.0
    rgb = rgb.astype(np.uint8)
    err = np.asarray(err, dtype=np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<ddd", *xyz[i]))
            f.write(struct.pack("<BBB", *rgb[i]))
            f.write(struct.pack("<d", err[i]))
            f.write(struct.pack("<Q", 0))          # empty track


def write_model(cams: Dict[int, ColmapCamera],
                images: Dict[int, ColmapImage],
                xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray,
                out_dir: str) -> None:
    """Write a full binary COLMAP sparse model directory."""
    os.makedirs(out_dir, exist_ok=True)
    write_cameras_binary(cams, os.path.join(out_dir, "cameras.bin"))
    write_images_binary(images, os.path.join(out_dir, "images.bin"))
    write_points3D_binary(xyz, rgb, err, os.path.join(out_dir,
                                                      "points3D.bin"))
