"""Gaussian projection: world space -> screen space, as flat vector math.

Numerics follow gsplat v1.x, as the JAX package's `project_3dgs` does:
  * perspective EWA with a frustum-limited Jacobian (1.3 * tan(fov/2) clamp)
  * eps2d = 0.3 added to the 2D covariance diagonal (the "AA blur")
  * conics stored as (c/det, -b/det, a/det), b the off-diagonal (not twice it)
  * radius = ceil(3 * sqrt(max eigenvalue of cov2d)), the radicand clipped
    at 0.01
  * a gaussian survives iff near < z < far, det(cov2d) > 0 and its
    [-r, +r] box meets the image; culled gaussians get radius 0.
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
