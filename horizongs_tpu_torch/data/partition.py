"""Large-scene chunk partitioning (VastGaussian-style) + LOD estimation.

A copy of `horizongs_tpu/data/partition.py` (this package imports nothing
of the JAX package). It is host numpy in both packages, float64 with the
same `np.unique` / `lexsort` order, so both write the same files byte for
byte. Port of `preprocess/data_preprocess.py` + `utils/partition_utils.py`
semantics:

  1. camera-count-balanced m x n region division on a ground plane
     (`camera_position_based_region_division`, :77-174)
  2. bounds expansion by `overlap_area` around each chunk's cameras
     (`position_based_data_selection`, :176-245)
  3. visibility-based camera borrowing + coverage-based point
     augmentation: an aerial camera joins a chunk when the convex hull
     of the chunk bbox's 8 projected corners covers >= `visible_rate`
     of its image (`..._aerial_street`, :334-429); borrowed cameras
     also contribute their visible points
  4. per-chunk datasets: chunks/{m}_{n}/points3d.ply + transforms.json
     (city format), plus partitions.json metadata (replacing the torch
     pickle at :432-457)
  5. LOD parameter estimation from camera-to-point distance quantiles
     (`data_preprocess.py:569-611`, minus the stray breakpoint())

Geometry only — no pixel loading.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional

import numpy as np

from horizongs_tpu_torch.core.cameras import fov_to_focal, world_to_view
from horizongs_tpu_torch.data.readers import BasicPointCloud, CameraInfo
from horizongs_tpu_torch.io.plyio import write_points_ply


class CamGeom:
    """Geometry-only camera for partitioning."""

    def __init__(self, info: CameraInfo, idx: int):
        self.info = info
        self.index = idx
        self.viewmat = world_to_view(info.R, info.T)
        self.center = np.linalg.inv(self.viewmat)[:3, 3]
        fx = fov_to_focal(info.fovx, info.width)
        fy = fov_to_focal(info.fovy, info.height)
        self.K = np.array([[fx, 0, info.cx], [0, fy, info.cy], [0, 0, 1]])
        self.width = info.width
        self.height = info.height
        self.image_path = info.image_path
        t = ("aerial" if "aerial" in info.image_path
             else "street" if "street" in info.image_path else "aerial")
        self.image_type = t


def point_in_image(cam: CamGeom, points: np.ndarray):
    """Project world points; returns (pixels_in_image, depths, mask)
    (`utils/partition_utils.py:169-210` semantics)."""
    p_cam = points @ cam.viewmat[:3, :3].T + cam.viewmat[:3, 3]
    z = p_cam[:, 2]
    uv = p_cam @ cam.K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        px = uv[:, 0] / z
        py = uv[:, 1] / z
    mask = (z > 0.01) & (px >= 0) & (px < cam.width) & (py >= 0) & (py < cam.height)
    return np.stack([px, py], axis=1)[mask], z[mask], mask


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain; points (N, 2) -> hull vertices CCW."""
    pts = np.unique(points, axis=0)
    if pts.shape[0] < 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(tuple(p))
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(tuple(p))
    return np.array(lower[:-1] + upper[:-1])


def _clip_polygon(poly: np.ndarray, w: float, h: float) -> np.ndarray:
    """Sutherland-Hodgman clip against the image rectangle."""
    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            cur, nxt = pts[i], pts[(i + 1) % n]
            ci, ni = inside(cur), inside(nxt)
            if ci:
                out.append(cur)
                if not ni:
                    out.append(intersect(cur, nxt))
            elif ni:
                out.append(intersect(cur, nxt))
        return out

    def x_cut(a, b, x):
        t = (x - a[0]) / (b[0] - a[0] + 1e-12)
        return (x, a[1] + t * (b[1] - a[1]))

    def y_cut(a, b, y):
        t = (y - a[1]) / (b[1] - a[1] + 1e-12)
        return (a[0] + t * (b[0] - a[0]), y)

    pts = [tuple(p) for p in poly]
    for inside, cut in (
            (lambda p: p[0] >= 0, lambda a, b: x_cut(a, b, 0.0)),
            (lambda p: p[0] <= w, lambda a, b: x_cut(a, b, w)),
            (lambda p: p[1] >= 0, lambda a, b: y_cut(a, b, 0.0)),
            (lambda p: p[1] <= h, lambda a, b: y_cut(a, b, h))):
        if not pts:
            return np.zeros((0, 2))
        pts = clip_edge(pts, inside, cut)
    return np.array(pts) if pts else np.zeros((0, 2))


def _area(poly: np.ndarray) -> float:
    if poly.shape[0] < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def hull_coverage(points2d: List[np.ndarray], w: int, h: int) -> float:
    """`run_graham_scan` (`partition_utils.py:130-167`): hull ∩ image
    area / image area."""
    hull = _convex_hull(np.asarray(points2d, dtype=np.float64))
    clipped = _clip_polygon(hull, float(w), float(h))
    return _area(clipped) / (w * h)


def bbox_corners(points: np.ndarray) -> np.ndarray:
    lo, hi = points.min(axis=0), points.max(axis=0)
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


def _balanced_segments(values: np.ndarray, lo: float, hi: float, m: int):
    """Camera-count-balanced 1D segmentation (`data_preprocess.py:96-114`)."""
    V = len(values)
    s = np.sort(values)
    segs = []
    seg_size = V / m
    for i in range(m):
        start = int(i * seg_size) if i == 0 else int(i * seg_size) + 1
        end = int((i + 1) * seg_size) if i < m - 1 else V
        lower = lo if i == 0 else s[min(start, V - 1)]
        upper = hi if i == m - 1 else s[min(end - 1, V - 1)]
        if i > 0 and lower > segs[-1][1]:
            lower = (segs[-1][1] + lower) / 2
            segs[-1] = (segs[-1][0], lower)
        segs.append((float(lower), float(upper)))
    return segs


def _in_bounds(x, y, xb, yb):
    return (x >= xb[0]) & (x <= xb[1]) & (y >= yb[0]) & (y <= yb[1])


def region_division(pcd: BasicPointCloud, cams: List[CamGeom],
                    m_region: int, n_region: int, plane=(0, 1)) -> Dict:
    px, py = plane
    pts_x, pts_y = pcd.points[:, px], pcd.points[:, py]
    cam_x = np.array([c.center[px] for c in cams])
    cam_y = np.array([c.center[py] for c in cams])
    # Bbox = points ∪ cameras. The reference uses the point bbox alone
    # (`data_preprocess.py:90-91`), which inverts segment bounds whenever
    # cameras sit outside the cloud footprint (e.g. orbit captures);
    # identical on its city scenes, where cameras lie inside.
    x_min, x_max = min(pts_x.min(), cam_x.min()), max(pts_x.max(), cam_x.max())
    y_min, y_max = min(pts_y.min(), cam_y.min()), max(pts_y.max(), cam_y.max())

    partitions = {}
    x_segs = _balanced_segments(cam_x, x_min, x_max, m_region)
    for mi, xseg in enumerate(x_segs):
        sel = [c for c in cams if xseg[0] <= c.center[px] <= xseg[1]]
        cam_y = np.array([c.center[py] for c in sel]) if sel else np.zeros(0)
        y_segs = _balanced_segments(cam_y, y_min, y_max, n_region) \
            if len(sel) else [(y_min, y_max)] * n_region
        for ni, yseg in enumerate(y_segs):
            pmask = _in_bounds(pts_x, pts_y, xseg, yseg)
            part_cams = [c for c in cams
                         if _in_bounds(c.center[px], c.center[py], xseg, yseg)]
            partitions[f"{mi}_{ni}"] = {
                "bounds": (list(xseg), list(yseg)),
                "pcd_mask": pmask,
                "cameras": part_cams,
            }
    return partitions


def expand_bounds(partitions: Dict, pcd: BasicPointCloud,
                  cams: List[CamGeom], overlap_area: float,
                  plane=(0, 1)) -> Dict:
    px, py = plane
    pts_x, pts_y = pcd.points[:, px], pcd.points[:, py]
    all_x = np.array([c.center[px] for c in cams])
    all_y = np.array([c.center[py] for c in cams])
    # points ∪ cameras, matching region_division (see note there)
    x_min, x_max = min(pts_x.min(), all_x.min()), max(pts_x.max(), all_x.max())
    y_min, y_max = min(pts_y.min(), all_y.min()), max(pts_y.max(), all_y.max())
    for pid, part in partitions.items():
        pc = np.array([c.center for c in part["cameras"]]) \
            if part["cameras"] else np.zeros((1, 3))
        cw = pc[:, px].max() - pc[:, px].min()
        ch = pc[:, py].max() - pc[:, py].min()
        xb, yb = part["bounds"]
        nxb = [max(min(xb[0], pc[:, px].min() - overlap_area * cw), x_min),
               min(max(xb[1], pc[:, px].max() + overlap_area * cw), x_max)]
        nyb = [max(min(yb[0], pc[:, py].min() - overlap_area * ch), y_min),
               min(max(yb[1], pc[:, py].max() + overlap_area * ch), y_max)]
        part["true_bounds"] = part["bounds"]
        part["bounds"] = (nxb, nyb)
        part["pcd_mask"] = _in_bounds(pts_x, pts_y, nxb, nyb)
        part["cameras"] = [c for c in cams
                           if _in_bounds(c.center[px], c.center[py], nxb, nyb)]
    return partitions


def visibility_selection(partitions: Dict, pcd: BasicPointCloud,
                         visible_rate: float) -> Dict:
    """Borrow aerial cameras (and their visible points) from other chunks."""
    out = {}
    for jid, jpart in partitions.items():
        jp = pcd.points[jpart["pcd_mask"]]
        if jp.shape[0] == 0:
            out[jid] = {**jpart, "extra_point_mask":
                        np.zeros(pcd.points.shape[0], bool)}
            continue
        corners = bbox_corners(jp)
        have = {c.image_path for c in jpart["cameras"]}
        cams = list(jpart["cameras"])
        extra_mask = np.zeros(pcd.points.shape[0], dtype=bool)
        for iid, ipart in partitions.items():
            if iid == jid:
                continue
            for cam in ipart["cameras"]:
                if cam.image_type != "aerial" or cam.image_path in have:
                    continue
                proj, _, _ = point_in_image(cam, corners)
                if proj.shape[0] <= 3:
                    continue
                if hull_coverage(list(proj), cam.width, cam.height) >= visible_rate:
                    have.add(cam.image_path)
                    cams.append(cam)
                    _, _, pmask = point_in_image(
                        cam, pcd.points[ipart["pcd_mask"]])
                    idxs = np.flatnonzero(ipart["pcd_mask"])[pmask]
                    extra_mask[idxs] = True
        out[jid] = {"true_bounds": jpart["true_bounds"],
                    "bounds": jpart["bounds"],
                    "pcd_mask": jpart["pcd_mask"],
                    "extra_point_mask": extra_mask,
                    "cameras": cams}
    return out


def save_partitions(partitions: Dict, pcd: BasicPointCloud, out_dir: str,
                    source_path: str, frames: Optional[List[dict]] = None,
                    visible_rate: float = 0.25) -> str:
    os.makedirs(out_dir, exist_ok=True)
    meta = {"visible_rate": visible_rate, "chunks": {}}
    for pid, part in partitions.items():
        cdir = os.path.join(out_dir, pid)
        os.makedirs(cdir, exist_ok=True)
        mask = part["pcd_mask"] | part.get(
            "extra_point_mask", np.zeros_like(part["pcd_mask"]))
        write_points_ply(os.path.join(cdir, "points3d.ply"),
                         pcd.points[mask], np.clip(pcd.colors[mask], 0, 1))
        if frames is not None:
            # match frames to cameras by file-path stem (camera lists may
            # merge train+test, so positional indices don't line up)
            by_stem = {os.path.splitext(os.path.basename(
                fr["file_path"]))[0]: fr for fr in frames}
            sel = []
            for cam in part["cameras"]:
                stem = os.path.splitext(os.path.basename(cam.image_path))[0]
                if stem not in by_stem:
                    continue
                fr = copy.deepcopy(by_stem[stem])
                fr["file_path"] = os.path.abspath(
                    os.path.join(source_path, fr["file_path"]))
                if "depth_path" in fr:
                    fr["depth_path"] = os.path.abspath(
                        os.path.join(source_path, fr["depth_path"]))
                sel.append(fr)
            with open(os.path.join(cdir, "transforms.json"), "w") as f:
                json.dump({"camera_angle_x": frames_angle(frames),
                           "frames": sel}, f)
        meta["chunks"][pid] = {
            "true_bounds": [list(map(float, b))
                            for b in part["true_bounds"]],
            "bounds": [list(map(float, b)) for b in part["bounds"]],
            # counts cameras whose frame was not written too (a test view
            # merged into the train list when eval is false), as the JAX
            # package does, so that partitions.json stays identical
            # (ROADMAP.md §3)
            "n_cameras": len(part["cameras"]),
            "n_points": int(mask.sum()),
        }
    path = os.path.join(out_dir, "partitions.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


def draw_partitions(partitions: Dict, pcd: BasicPointCloud, out_path: str,
                    plane=(0, 1), max_points: int = 200_000) -> Optional[str]:
    """Partition overview plot (`utils/partition_utils.py:213-259`):
    decimated point cloud, per-chunk expanded bounds (colored rects),
    true bounds (dashed), and camera centers per chunk. Best-effort —
    returns None when matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle
    except ImportError:
        return None
    u, v = plane
    pts = pcd.points
    if len(pts) > max_points:
        pts = pts[:: len(pts) // max_points]
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(pts[:, u], pts[:, v], s=0.2, c="lightgray", linewidths=0)
    cmap = plt.get_cmap("tab20")
    for i, (pid, part) in enumerate(sorted(partitions.items())):
        color = cmap(i % 20)
        for key, style in (("bounds", "-"), ("true_bounds", "--")):
            (xlo, xhi), (ylo, yhi) = part[key]
            ax.add_patch(Rectangle((xlo, ylo), xhi - xlo, yhi - ylo,
                                   fill=False, edgecolor=color,
                                   linestyle=style, linewidth=1.5))
        centers = np.asarray([c.center for c in part["cameras"]])
        if len(centers):
            ax.scatter(centers[:, u], centers[:, v], s=6, color=color,
                       linewidths=0)
        (xlo, xhi), (ylo, yhi) = part["true_bounds"]
        ax.text(0.5 * (xlo + xhi), 0.5 * (ylo + yhi), pid, color=color,
                ha="center", va="center", fontsize=10, weight="bold")
    ax.set_aspect("equal")
    ax.set_title(f"{len(partitions)} chunks "
                 f"(solid: expanded bounds, dashed: true bounds)")
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return out_path


def frames_angle(frames):
    return frames[0].get("camera_angle_x") if frames else None


def estimate_lod_params(points: np.ndarray, cams: List[CamGeom], fork: int,
                        dist_ratio: float = 0.9, aerial_lod: str = "multi",
                        street_lod: str = "multi") -> dict:
    """LOD estimation (`data_preprocess.py:569-611`)."""
    import math
    aerial, street = [], []
    for cam in cams:
        d = np.linalg.norm(points - cam.center[None], axis=1)
        pair = [np.quantile(d, 1 - dist_ratio), np.quantile(d, dist_ratio)]
        (aerial if cam.image_type == "aerial" else street).extend(pair)
    aerial = np.asarray(aerial) if aerial else np.asarray(street)
    street = np.asarray(street) if street else aerial
    a_max, a_min = np.quantile(aerial, dist_ratio), np.quantile(aerial, 1 - dist_ratio)
    s_min = np.quantile(street, 1 - dist_ratio)
    logf = math.log2(fork)
    if aerial_lod == "single":
        standard_dist = float(a_min)
        aerial_levels = 1
        street_levels = 2 if street_lod == "single" else int(
            np.floor(np.log2(a_min / s_min) / logf)) + 1
    else:
        standard_dist = float(a_max)
        aerial_levels = int(np.floor(np.log2(a_max / a_min) / logf)) + 1
        street_levels = int(np.floor(np.log2(a_max / s_min) / logf)) + 1
    return {"standard_dist": standard_dist,
            "aerial_levels": max(aerial_levels, 1),
            "street_levels": max(street_levels, aerial_levels + 1)}


def run_partition(pcd: BasicPointCloud, infos: List[CameraInfo],
                  m_region: int, n_region: int, out_dir: str,
                  source_path: str = "", overlap_area: float = 0.1,
                  visible_rate: float = 0.25, plane=(0, 1),
                  frames: Optional[List[dict]] = None) -> Dict:
    cams = [CamGeom(info, i) for i, info in enumerate(infos)]
    parts = region_division(pcd, cams, m_region, n_region, plane)
    parts = expand_bounds(parts, pcd, cams, overlap_area, plane)
    parts = visibility_selection(parts, pcd, visible_rate)
    save_partitions(parts, pcd, out_dir, source_path, frames, visible_rate)
    draw_partitions(parts, pcd, os.path.join(out_dir, "partitions.png"),
                    plane=plane)
    return parts
