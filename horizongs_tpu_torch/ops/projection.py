"""Gaussian projection: world space -> screen space, as flat vector math.

Numerics follow gsplat v1.x, as the JAX package's `project_3dgs` does:
  * perspective EWA with a frustum-limited Jacobian (1.3 * tan(fov/2) clamp)
  * eps2d = 0.3 added to the 2D covariance diagonal (the "AA blur")
  * conics stored as (c/det, -b/det, a/det), b the off-diagonal (not twice it)
  * radius = ceil(3 * sqrt(max eigenvalue of cov2d)), the radicand clipped
    at 0.01
  * a gaussian survives iff near < z < far, det(cov2d) > 0 and its
    [-r, +r] box meets the image; culled gaussians get radius 0.
`project_2dgs` is the surfel (2DGS) counterpart: the (u, v, 1) -> screen
transform M of each splat, its camera-facing normal and the AABB of its
3-sigma disk.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from horizongs_tpu_torch.core.transforms import quat_to_rotmat

EPS2D = 0.3
NEAR_PLANE = 0.01
FAR_PLANE = 1e10


class ProjectedGaussians(NamedTuple):
    radii: torch.Tensor          # (N,) float32, 0 => culled
    means2d: torch.Tensor        # (N, 2) pixel coords
    depths: torch.Tensor         # (N,) camera-space z
    conics: torch.Tensor         # (N, 3) upper triangle of inverse cov2d


def _rot_rows(W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3,3) @ (N,3)^T as nine scalar-broadcast products -> (N,3), the JAX
    package's order of operations."""
    return torch.stack(
        [W[i, 0] * v[:, 0] + W[i, 1] * v[:, 1] + W[i, 2] * v[:, 2]
         for i in range(3)], dim=-1)


def project_3dgs(
    means: torch.Tensor,    # (N, 3)
    quats: torch.Tensor,    # (N, 4) wxyz
    scales: torch.Tensor,   # (N, 3) positive
    viewmat: torch.Tensor,  # (4, 4)
    K: torch.Tensor,        # (3, 3)
    width: int,
    height: int,
) -> ProjectedGaussians:
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    W = viewmat[:3, :3]
    p_cam = _rot_rows(W, means) + viewmat[:3, 3]               # (N, 3)
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    valid = (z > NEAR_PLANE) & (z < FAR_PLANE)
    zs = torch.where(valid, z, torch.ones_like(z))

    # cov2d = J W Sigma W^T J^T with Sigma = R S^2 R^T, factored as V V^T
    # where V = J @ (W @ R) @ S
    R = quat_to_rotmat(quats)                                  # (N, 3, 3)
    WRs = [[(W[i, 0] * R[:, 0, k] + W[i, 1] * R[:, 1, k]
             + W[i, 2] * R[:, 2, k]) * scales[:, k]
            for k in range(3)] for i in range(3)]

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = zs * torch.clamp(x / zs, -lim_x, lim_x)
    ty = zs * torch.clamp(y / zs, -lim_y, lim_y)
    rz = 1.0 / zs
    rz2 = rz * rz
    # J rows: [fx*rz, 0, -fx*tx*rz^2], [0, fy*rz, -fy*ty*rz^2]
    j00, j02 = fx * rz, -fx * tx * rz2
    j11, j12 = fy * rz, -fy * ty * rz2
    v0 = [j00 * WRs[0][k] + j02 * WRs[2][k] for k in range(3)]
    v1 = [j11 * WRs[1][k] + j12 * WRs[2][k] for k in range(3)]
    a = v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2]
    b = v0[0] * v1[0] + v0[1] * v1[1] + v0[2] * v1[2]
    c = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2]
    a = a + EPS2D
    c = c + EPS2D
    det = a * c - b * b

    # `valid` feeds torch.where in the graph above, so it is never updated
    # in place
    valid = valid & (det > 0.0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.01))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    mean_x = fx * x * rz + cx
    mean_y = fy * y * rz + cy
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    valid = (valid & (radius > 0.0)
             & (mean_x + radius > 0) & (mean_x - radius < width)
             & (mean_y + radius > 0) & (mean_y - radius < height))

    radii = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedGaussians(radii=radii, means2d=means2d, depths=z,
                              conics=conic)


class ProjectedSurfels(NamedTuple):
    """2DGS projection output: the splat-to-screen ray transform + bounds."""
    radii: torch.Tensor        # (N,) float32, 0 => culled
    means2d: torch.Tensor      # (N, 2) projected splat centres (pixels)
    depths: torch.Tensor       # (N,) camera-space z of the splat centre
    transforms: torch.Tensor   # (N, 3, 3) M: (u, v, 1) -> screen homogeneous
    normals: torch.Tensor      # (N, 3) camera-space normals facing the camera


def _metric_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a·b·(9, 9, -1) over the last axis: the (3σ, 3σ, -1) metric of the
    disk's homogeneous bounding test, summed left to right."""
    return a[:, 0] * b[:, 0] * 9.0 + a[:, 1] * b[:, 1] * 9.0 - a[:, 2] * b[:, 2]


def project_2dgs(
    means: torch.Tensor,    # (N, 3)
    quats: torch.Tensor,    # (N, 4) wxyz
    scales: torch.Tensor,   # (N, 3): only the first two axes are used
    viewmat: torch.Tensor,  # (4, 4)
    K: torch.Tensor,        # (3, 3)
    width: int,
    height: int,
) -> ProjectedSurfels:
    """Project 2D gaussians (surfels), as the JAX package's `project_2dgs`.

    A surfel point is x(u, v) = p + u·s0·r0 + v·s1·r1 with r0, r1 the first
    two rotation columns; its screen homogeneous coordinate is M (u, v, 1)
    with M = K [W r0 s0, W r1 s1, W p + t]. The rasterizer intersects pixel
    rays with the splat plane through M, so no 2D covariance is needed. The
    AABB of the 3σ disk comes from M's rows under the (9, 9, -1) metric:
    d = M3·M3', centre (M1·M3'/d, M2·M3'/d), half extent² = centre² -
    (M1·M1'/d, M2·M2'/d); a surfel survives iff near < z < far, |d| > 1e-10,
    both half extents² > 0 and its [-r, +r] box meets the image."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    W = viewmat[:3, :3]
    p_cam = _rot_rows(W, means) + viewmat[:3, 3]               # (N, 3)
    z = p_cam[:, 2]
    valid = (z > NEAR_PLANE) & (z < FAR_PLANE)

    R = quat_to_rotmat(quats)                                  # (N, 3, 3)
    u0 = _rot_rows(W, R[:, :, 0])                              # unit tangents
    u1 = _rot_rows(W, R[:, :, 1])                              # in camera space
    r0_cam = u0 * scales[:, 0:1]
    r1_cam = u1 * scales[:, 1:2]
    normal = torch.stack([u0[:, 1] * u1[:, 2] - u0[:, 2] * u1[:, 1],
                          u0[:, 2] * u1[:, 0] - u0[:, 0] * u1[:, 2],
                          u0[:, 0] * u1[:, 1] - u0[:, 1] * u1[:, 0]], dim=-1)
    normal = normal / torch.clamp_min(
        torch.linalg.norm(normal, dim=-1, keepdim=True), 1e-12)
    # flip normals to face the camera (the ray direction is ~ p_cam)
    facing = torch.sum(normal * p_cam, dim=-1)
    normal = torch.where((facing > 0)[:, None], -normal, normal)

    # M's columns are [r0_cam, r1_cam, p_cam]; K applied row by row
    cols = torch.stack([r0_cam, r1_cam, p_cam], dim=-1)        # (N, 3, 3)
    M = torch.stack([fx * cols[:, 0, :] + cx * cols[:, 2, :],
                     fy * cols[:, 1, :] + cy * cols[:, 2, :],
                     cols[:, 2, :]], dim=-2)                   # (N, 3, 3)

    M1, M2, M3 = M[:, 0, :], M[:, 1, :], M[:, 2, :]
    d = _metric_dot(M3, M3)
    d_ok = torch.abs(d) > 1e-10
    d_safe = torch.where(d_ok, d, torch.ones_like(d))
    center_x = _metric_dot(M1, M3) / d_safe
    center_y = _metric_dot(M2, M3) / d_safe
    half_x2 = center_x * center_x - _metric_dot(M1, M1) / d_safe
    half_y2 = center_y * center_y - _metric_dot(M2, M2) / d_safe
    radius = torch.ceil(torch.sqrt(torch.clamp_min(
        torch.maximum(half_x2, half_y2), 0.0)))

    means2d = torch.stack([center_x, center_y], dim=-1)
    valid = (valid & d_ok & (half_x2 > 0) & (half_y2 > 0) & (radius > 0.0)
             & (center_x + radius > 0) & (center_x - radius < width)
             & (center_y + radius > 0) & (center_y - radius < height))
    radii = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedSurfels(radii=radii, means2d=means2d, depths=z,
                            transforms=M, normals=normal)
