"""TSDF fusion + marching-tetrahedra mesh extraction, the JAX package's
`utils/meshing.py` (in place of the reference's Open3D
ScalableTSDFVolume pipeline, `utils/mesh_utils.py:94-204`): depth maps
rendered from the 2DGS model are fused into a truncated signed distance
volume; the zero level set is triangulated with marching tetrahedra
(table-free, unlike marching cubes), and the largest connected component
is kept (`post_process_mesh`, `mesh_utils.py:22-43`).

The fusion (`fuse_tsdf`, `fuse_tsdf_contracted`) is tensor code on a
device (the card by default) over every voxel and view, in float64 as
the JAX package's host numpy is: `floor(u)` and `floor(v)` pick the pixel
a voxel reads, so a float32 grid would read other pixels at the pixel
boundaries. Each product and sum is its own operation in numpy's order
(no matrix product, whose summation order a BLAS chooses), so the CPU's
grid equals the JAX package's and the card's the CPU's to rounding (the
card divides by a scalar through its reciprocal). The rest
(contraction, marching tetrahedra, components, the mesh PLY) is host
numpy, copied from the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from horizongs_tpu_torch.device import DeviceLike, resolve_device


def estimate_bounding_sphere(cam_centers: np.ndarray) -> Tuple[np.ndarray, float]:
    """Scene center/radius from (aerial) camera origins
    (`GaussianExtractor.estimate_bounding_sphere`, `mesh_utils.py:113-133`)."""
    center = cam_centers.mean(axis=0)
    radius = np.linalg.norm(cam_centers - center[None], axis=1).min()
    return center, float(radius)


def _tensor(x, dev: torch.device) -> torch.Tensor:
    """An array (copied: it may be read-only) or tensor on `dev`, its
    dtype kept."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(dev)


def _f64(x, dev: torch.device) -> torch.Tensor:
    return _tensor(x, dev).double()


def _norm(y: torch.Tensor) -> torch.Tensor:
    """|y| over the last axis of (V, 3), summed in numpy's order."""
    return torch.sqrt(y[:, 0] * y[:, 0] + y[:, 1] * y[:, 1]
                      + y[:, 2] * y[:, 2])


def _grid(origin: torch.Tensor, voxel_size: float, dims) -> torch.Tensor:
    """(X*Y*Z, 3) float64 voxel centres, x slowest."""
    axes = [origin[i] + (torch.arange(n, dtype=torch.float64,
                                      device=origin.device) + 0.5)
            * voxel_size for i, n in enumerate(dims)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def _project(pts: torch.Tensor, depth, alpha, viewmat, K, valid,
             depth_trunc: float, alpha_thres: float):
    """One view: each voxel's camera z, the depth it reads and whether
    it is valid so far (in front, inside the image, a hit of alpha above
    the threshold within the depth range). `viewmat` and `K` are float32
    promoted to float64, as numpy promotes them; `pts @ R.T + t` is summed
    term by term."""
    dev = pts.device
    R, t = _f64(viewmat, dev)[:3, :3], _f64(viewmat, dev)[:3, 3]
    Kd = _f64(K, dev)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    p = [x * R[r, 0] + y * R[r, 1] + z * R[r, 2] + t[r] for r in range(3)]
    zc = p[2]
    valid = valid & (zc > 1e-6)
    zs = torch.where(valid, zc, 1.0)
    u = p[0] / zs * Kd[0, 0] + Kd[0, 2]
    v = p[1] / zs * Kd[1, 1] + Kd[1, 2]
    depth = _tensor(depth, dev)
    H, W = depth.shape
    ui = torch.floor(u).long()
    vi = torch.floor(v).long()
    valid = valid & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    ui = ui.clamp(0, W - 1)
    vi = vi.clamp(0, H - 1)
    d = depth[vi, ui]
    a = (_tensor(alpha, dev)[vi, ui] if alpha is not None
         else torch.ones_like(d))
    valid = valid & (d > 0) & (d < depth_trunc) & (a > alpha_thres)
    return zc, d.double(), valid


def fuse_tsdf(depths: List, alphas: List, viewmats: List, Ks: List,
              origin: np.ndarray, voxel_size: float,
              dims: Tuple[int, int, int], sdf_trunc: float,
              depth_trunc: float = 1e9, alpha_thres: float = 0.5,
              device: DeviceLike = None):
    """Integrate depth maps (H, W) (arrays or tensors) into a TSDF grid
    on `device`. Returns numpy float64 (tsdf (X,Y,Z), weights (X,Y,Z));
    unobserved voxels keep tsdf=1 (outside)."""
    dev = resolve_device(device)
    X, Y, Z = dims
    pts = _grid(_f64(origin, dev), voxel_size, dims)
    tsdf = torch.ones(pts.shape[0], dtype=torch.float64, device=dev)
    weight = torch.zeros_like(tsdf)
    always = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    for depth, alpha, viewmat, K in zip(depths, alphas, viewmats, Ks):
        z, d, valid = _project(pts, depth, alpha, viewmat, K, always,
                               depth_trunc, alpha_thres)
        sdf = d - z                                           # + outside
        valid = valid & (sdf > -sdf_trunc)
        sdf = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
        w_new = valid.double()
        tsdf = torch.where(weight + w_new > 0,
                           (tsdf * weight + sdf * w_new)
                           / torch.clamp_min(weight + w_new, 1e-12), tsdf)
        weight = weight + w_new
    return (tsdf.reshape(X, Y, Z).cpu().numpy(),
            weight.reshape(X, Y, Z).cpu().numpy())


def contract(x: np.ndarray) -> np.ndarray:
    """Mip-NeRF-360 scene contraction: identity inside the unit ball,
    radius 2 - 1/|x| outside — maps all of R^3 into the radius-2 ball
    (reference `extract_mesh_unbounded.contract`,
    `utils/mesh_utils.py:184-186`)."""
    mag = np.linalg.norm(x, axis=-1, keepdims=True)
    safe = np.maximum(mag, 1e-12)
    return np.where(mag < 1, x, (2.0 - 1.0 / safe) * (x / safe))


def uncontract(y: np.ndarray) -> np.ndarray:
    """Inverse contraction (`mesh_utils.py:188-190`); diverges as
    |y| -> 2, so callers mask grid points near the boundary."""
    mag = np.linalg.norm(y, axis=-1, keepdims=True)
    safe = np.maximum(mag, 1e-12)
    return np.where(mag < 1, y, (1.0 / np.maximum(2.0 - mag, 1e-6))
                    * (y / safe))


def _uncontract(y: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """`uncontract` on the device, |y| given."""
    mag = mag[:, None]
    safe = torch.clamp_min(mag, 1e-12)
    return torch.where(mag < 1, y, (1.0 / torch.clamp_min(2.0 - mag, 1e-6))
                       * (y / safe))


def fuse_tsdf_contracted(depths: List, alphas: List, viewmats: List,
                         Ks: List, center: np.ndarray, radius: float,
                         resolution: int = 128,
                         sdf_trunc_vox: float = 4.0,
                         depth_trunc: float = 1e9,
                         alpha_thres: float = 0.5,
                         device: DeviceLike = None):
    """TSDF fusion over a CONTRACTED-space grid for unbounded scenes, on
    `device`.

    The scene is normalized by the (aerial-camera) bounding sphere, the
    grid spans the contracted radius-2 ball at `resolution`^3, and each
    voxel's truncation band scales with the local stretch of the inverse
    contraction: near voxels keep fine detail, the periphery integrates
    coarsely instead of being cut off at a bounding box. The JAX
    package's completion of the reference's `extract_mesh_unbounded`
    (`utils/mesh_utils.py:179-204`, shipped truncated mid-function). The
    geometry is float64; the signed distances and weights are accumulated
    in float32, as the JAX package accumulates them.

    Returns (tsdf (N,N,N), weights (N,N,N), origin, voxel_size) as numpy,
    in contracted units; un-map vertices with
    `center + radius * uncontract(v)`."""
    dev = resolve_device(device)
    N = resolution
    voxel_size = 4.0 / N
    origin = np.full(3, -2.0, dtype=np.float64)
    ys = _grid(_f64(origin, dev), voxel_size, (N, N, N))
    mag = _norm(ys)
    reachable = mag < 2.0 - 2.0 * voxel_size
    world = _f64(center, dev)[None, :] + radius * _uncontract(ys, mag)
    # radial derivative of uncontract: 1 inside the unit ball,
    # 1/(2-|y|)^2 outside: the world-space size a contracted voxel covers
    stretch = torch.where(mag < 1.0, 1.0,
                          1.0 / torch.clamp_min(2.0 - mag, 1e-6) ** 2)
    trunc_w = sdf_trunc_vox * voxel_size * radius * stretch

    tsdf = torch.ones(ys.shape[0], dtype=torch.float32, device=dev)
    weight = torch.zeros_like(tsdf)
    for depth, alpha, viewmat, K in zip(depths, alphas, viewmats, Ks):
        z, d, valid = _project(world, depth, alpha, viewmat, K, reachable,
                               depth_trunc, alpha_thres)
        sdf = d - z
        valid = valid & (sdf > -trunc_w)
        sdf = torch.clamp(sdf / trunc_w, -1.0, 1.0).float()
        w_new = valid.float()
        tsdf = torch.where(weight + w_new > 0,
                           (tsdf * weight + sdf * w_new)
                           / torch.clamp_min(weight + w_new, 1e-12), tsdf)
        weight = weight + w_new
    return (tsdf.reshape(N, N, N).cpu().numpy(),
            weight.reshape(N, N, N).cpu().numpy(), origin, voxel_size)


def extract_mesh_unbounded(depths, alphas, viewmats, Ks,
                           cam_centers: np.ndarray,
                           resolution: int = 128,
                           depth_trunc: float = 1e9,
                           alpha_thres: float = 0.5,
                           device: DeviceLike = None):
    """Full unbounded pipeline: bounding-sphere normalize -> contracted
    TSDF fusion -> marching tetrahedra -> un-contract vertices ->
    largest cluster. Returns (verts, faces) in world coordinates; the
    fusion runs on `device`."""
    center, radius = estimate_bounding_sphere(np.asarray(cam_centers))
    tsdf, weight, origin, voxel_size = fuse_tsdf_contracted(
        depths, alphas, viewmats, Ks, center, radius,
        resolution=resolution, depth_trunc=depth_trunc,
        alpha_thres=alpha_thres, device=device)
    verts_c, faces = marching_tetrahedra(tsdf, weight, origin, voxel_size)
    verts = center[None, :] + radius * uncontract(verts_c) \
        if verts_c.shape[0] else verts_c
    return largest_component(verts, faces)


# the 6-tetrahedra decomposition of a cube sharing the 0-7 diagonal;
# corner c of the unit cube has offset bits (c&1, (c>>1)&1, (c>>2)&1)
_TETS = np.array([
    [0, 1, 5, 7], [0, 5, 4, 7], [0, 4, 6, 7],
    [0, 6, 2, 7], [0, 2, 3, 7], [0, 3, 1, 7]])
_CORNER_OFF = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)])


def marching_tetrahedra(tsdf: np.ndarray, weights: Optional[np.ndarray],
                        origin: np.ndarray, voxel_size: float,
                        min_weight: float = 0.5):
    """Zero-isosurface triangles of a TSDF grid. Returns (verts (M,3),
    faces (T,3))."""
    X, Y, Z = tsdf.shape
    # valid cube: all 8 corners observed
    cx, cy, cz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing="ij")
    cubes = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)     # (C, 3)
    corner_idx = cubes[:, None, :] + _CORNER_OFF[None, :, :]   # (C, 8, 3)
    vals = tsdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    if weights is not None:
        wv = weights[corner_idx[..., 0], corner_idx[..., 1],
                     corner_idx[..., 2]]
        observed = (wv >= min_weight).all(axis=1)
        cubes, corner_idx, vals = (cubes[observed], corner_idx[observed],
                                   vals[observed])
    # skip cubes with uniform sign quickly
    inside = vals < 0
    mixed = inside.any(axis=1) & (~inside).any(axis=1)
    cubes, corner_idx, vals = cubes[mixed], corner_idx[mixed], vals[mixed]
    if cubes.shape[0] == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    corner_pos = (origin[None, None, :]
                  + (corner_idx.astype(np.float64) + 0.5) * voxel_size)

    tri_list = []
    for tet in _TETS:
        tv = vals[:, tet]                                      # (C, 4)
        tp = corner_pos[:, tet]                                # (C, 4, 3)
        neg = tv < 0
        count = neg.sum(axis=1)

        def edge_point(sel, a, b):
            va, vb = tv[sel][:, a], tv[sel][:, b]
            t = va / (va - vb + 1e-12)
            return tp[sel][:, a] + t[:, None] * (tp[sel][:, b] - tp[sel][:, a])

        # one corner inside: triangle on the 3 edges from it
        for c1 in range(4):
            rest = [x for x in range(4) if x != c1]
            sel = (count == 1) & neg[:, c1]
            if sel.any():
                tri_list.append(np.stack(
                    [edge_point(sel, c1, rest[0]),
                     edge_point(sel, c1, rest[1]),
                     edge_point(sel, c1, rest[2])], axis=1))
            sel3 = (count == 3) & ~neg[:, c1]
            if sel3.any():
                tri_list.append(np.stack(
                    [edge_point(sel3, rest[0], c1),
                     edge_point(sel3, rest[1], c1),
                     edge_point(sel3, rest[2], c1)], axis=1))
        # two inside: quad from 4 crossing edges -> 2 triangles
        for pair in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
            a, b = pair
            cd = [x for x in range(4) if x not in pair]
            sel = (count == 2) & neg[:, a] & neg[:, b]
            if sel.any():
                p_ac = edge_point(sel, a, cd[0])
                p_ad = edge_point(sel, a, cd[1])
                p_bc = edge_point(sel, b, cd[0])
                p_bd = edge_point(sel, b, cd[1])
                tri_list.append(np.stack([p_ac, p_bc, p_bd], axis=1))
                tri_list.append(np.stack([p_ac, p_bd, p_ad], axis=1))

    if not tri_list:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tris = np.concatenate(tri_list, axis=0)                    # (T, 3, 3)

    # weld vertices
    flat = tris.reshape(-1, 3)
    key = np.round(flat / (voxel_size * 1e-4)).astype(np.int64)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3))
    np.add.at(verts, inverse, flat)
    counts = np.bincount(inverse, minlength=uniq.shape[0])
    verts /= counts[:, None]
    faces = inverse.reshape(-1, 3)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest connected triangle cluster (`post_process_mesh`)."""
    if faces.shape[0] == 0:
        return verts, faces
    parent = np.arange(verts.shape[0])

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(v) for v in range(verts.shape[0])])
    face_root = roots[faces[:, 0]]
    best = np.bincount(face_root).argmax()
    keep_faces = faces[face_root == best]
    used = np.unique(keep_faces)
    remap = -np.ones(verts.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    return verts[used], remap[keep_faces]


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary PLY with a face element (list property)."""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {verts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {faces.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        rec = np.empty(faces.shape[0],
                       dtype=[("n", "u1"), ("v", "<i4", (3,))])
        rec["n"] = 3
        rec["v"] = faces.astype(np.int32)
        f.write(rec.tobytes())


def read_mesh_ply(path: str):
    """Read back a mesh PLY written by write_mesh_ply."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header") + len(b"end_header") + 1
    header = data[:end].decode("ascii").splitlines()
    nv = nf = 0
    for line in header:
        if line.startswith("element vertex"):
            nv = int(line.split()[2])
        elif line.startswith("element face"):
            nf = int(line.split()[2])
    body = data[end:]
    verts = np.frombuffer(body, dtype="<f4", count=nv * 3).reshape(nv, 3)
    off = nv * 12
    rec = np.frombuffer(body[off:], dtype=[("n", "u1"), ("v", "<i4", (3,))],
                        count=nf)
    return verts.astype(np.float64), rec["v"].astype(np.int64)
