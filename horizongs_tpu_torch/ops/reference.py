"""Dense oracle renderer: per-pixel alpha compositing over all gaussians.

The port's own small-scene reference, a straight-line PyTorch version of
the JAX package's `render_dense_3dgs`: gaussians sorted by depth, front to
back; sigma = ½ dᵀ Conic d; alpha = min(0.999, op·exp(-sigma)), dropped
below 1/255; a gaussian contributes iff the transmittance before it is
> 1e-4; color = Σ w_i c_i + T_final·background with w_i = alpha_i·T_i.
O(pixels × gaussians), so only gaussians that can contribute (radius > 0
and opacity at or above the cutoff, which no pixel's alpha can otherwise
reach) are composited, in pixel chunks that bound memory.

`render_dense_2dgs` is the surfel (2DGS) oracle, the JAX package's: each
pixel ray meets each splat's plane at (u, v) = (k_x, k_y)/k_z with
k = (px·M3 - M1) × (py·M3 - M2); rho = min(u² + v², 2·|p - mean2d|²) (the
screen-space low-pass); alpha = min(0.999, op·exp(-rho/2)), dropped below
1/255 and where the hit's depth z = M3·(u, v, 1) is at or below 0.01. It
adds the accumulated normals, the depth distortion (2DGS eq. 15) and the
median depth (the depth of the gaussian after which T < 0.5) to the 3DGS
outputs, and `depth_to_normals` turns the median depth into normals.
"""
from __future__ import annotations

from typing import Optional

import torch

from horizongs_tpu_torch.core.sh import eval_sh
from horizongs_tpu_torch.ops.projection import project_2dgs, project_3dgs

ALPHA_CUTOFF = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999
# 2DGS screen-space low-pass filter: rho = min(rho_3d, FILTER_INV_SQUARE * d^2)
FILTER_INV_SQUARE_2DGS = 2.0
KZ_EPS = 1e-9             # |k_z| at or below this: the ray grazes the plane
Z_MIN = 0.01              # a 2DGS hit at or nearer than this is dropped
_CHUNK_ELEMS = 1 << 24    # pixel-chunk x gaussian elements per temporary


def _sh_colors(colors: torch.Tensor, sh_degree: Optional[int],
               means: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """(N, K, 3) SH coeffs -> (N, 3) clamped RGB; passthrough for (N, 3)."""
    if sh_degree is None:
        return colors
    dirs = means - cam_pos[None, :]
    dirs = dirs / torch.clamp_min(
        torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
    return torch.clamp_min(eval_sh(sh_degree, colors, dirs) + 0.5, 0.0)


def _composite_chunk_3dgs(px, py, means2d, conics, opacities, colors,
                          depths):
    """Composite P pixels (px, py: (P,)) against depth-sorted gaussians.
    Returns (P, C) color sum, (P,) alpha, (P,) depth sum, (P,) T_final."""
    dx = px[:, None] - means2d[None, :, 0]          # (P, N)
    dy = py[:, None] - means2d[None, :, 1]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    sigma = 0.5 * (a[None] * dx * dx + c[None] * dy * dy) + b[None] * dx * dy
    alpha = torch.clamp_max(opacities[None, :] * torch.exp(-sigma), MAX_ALPHA)
    alpha = torch.where((sigma >= 0) & (alpha >= ALPHA_CUTOFF), alpha,
                        torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    # exclusive prefix product of (1 - alpha): T_i = prod_{j<i} (1 - alpha_j)
    T = torch.cat([torch.ones_like(alpha[:, :1]),
                   torch.cumprod(one_minus, dim=1)[:, :-1]], dim=1)
    w = torch.where(T > TRANSMITTANCE_EPS, alpha * T, torch.zeros_like(T))
    color_sum = w @ colors
    alpha_sum = w.sum(dim=1)
    depth_sum = w @ depths
    T_final = torch.where(w > 0, one_minus, torch.ones_like(w)).prod(dim=1)
    return color_sum, alpha_sum, depth_sum, T_final


def render_dense_3dgs(
    means: torch.Tensor,      # (N, 3)
    quats: torch.Tensor,      # (N, 4)
    scales: torch.Tensor,     # (N, 3)
    opacities: torch.Tensor,  # (N,)
    colors: torch.Tensor,     # (N, 3) RGB or (N, K, 3) SH
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    background: torch.Tensor,  # (C_color,)
    sh_degree: Optional[int] = None,
    render_mode: str = "RGB",
    means2d_probe: Optional[torch.Tensor] = None,
):
    """Returns (render (H, W, C), alphas (H, W, 1), info dict).
    Differentiable under autograd; `means2d_probe` (N, 2), when given, is
    added to the projected means (the JAX oracle's `means2d_override`)."""
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    proj = project_3dgs(means, quats, scales, viewmat, K, width, height)
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_colors(colors, sh_degree, means, cam_pos)

    order = _depth_sorted(proj, opacities)
    s_means2d = proj.means2d[order]
    s_conics = proj.conics[order]
    s_opac = opacities[order]
    s_rgb = rgb[order]
    s_depths = proj.depths[order]

    xs, ys = _pixel_centres(width, height, means.device)
    n_pix = height * width
    chunk = max(1, min(4096, _CHUNK_ELEMS // max(order.numel(), 1)))
    parts = [_composite_chunk_3dgs(xs[s:s + chunk], ys[s:s + chunk],
                                   s_means2d, s_conics, s_opac, s_rgb,
                                   s_depths)
             for s in range(0, n_pix, chunk)]
    color_sum, alpha_sum, depth_sum, T_final = (
        torch.cat(p, dim=0) for p in zip(*parts))

    render = color_sum + T_final[:, None] * background[None, :]
    render = render.reshape(height, width, -1)
    alphas = alpha_sum.reshape(height, width, 1)

    if render_mode == "RGB+D":
        render = torch.cat([render, depth_sum.reshape(height, width, 1)],
                           dim=-1)
    elif render_mode == "RGB+ED":
        depth = depth_sum / torch.clamp_min(alpha_sum, 1e-10)
        render = torch.cat([render, depth.reshape(height, width, 1)], dim=-1)

    info = {"radii": proj.radii, "means2d": proj.means2d,
            "depths": proj.depths, "conics": proj.conics}
    return render, alphas, info


def _depth_sorted(proj, opacities: torch.Tensor) -> torch.Tensor:
    """Indices of the gaussians that can contribute, by depth (a stable
    sort: equal depths keep their index order)."""
    keep = (proj.radii > 0) & (opacities >= ALPHA_CUTOFF)
    idx = torch.nonzero(keep).squeeze(1)
    return idx[torch.sort(proj.depths[idx], stable=True).indices]


def _pixel_centres(width: int, height: int, device):
    n_pix = height * width
    ys = (torch.arange(n_pix, device=device) // width).float() + 0.5
    xs = (torch.arange(n_pix, device=device) % width).float() + 0.5
    return xs, ys


def _composite_chunk_2dgs(px, py, transforms, means2d, opacities, colors,
                          normals):
    """2DGS ray-splat compositing of P pixels (px, py: (P,)) against
    depth-sorted surfels (transforms (N, 3, 3)). Returns the color (P, C),
    alpha, depth, normal (P, 3), distortion, median depth and T_final sums
    (each (P,) unless shaped)."""
    M1, M2, M3 = transforms[:, 0, :], transforms[:, 1, :], transforms[:, 2, :]
    X, Y = px[:, None], py[:, None]
    hux, huy, huz = X * M3[:, 0] - M1[:, 0], X * M3[:, 1] - M1[:, 1], \
        X * M3[:, 2] - M1[:, 2]
    hvx, hvy, hvz = Y * M3[:, 0] - M2[:, 0], Y * M3[:, 1] - M2[:, 1], \
        Y * M3[:, 2] - M2[:, 2]
    kx = huy * hvz - huz * hvy
    ky = huz * hvx - hux * hvz
    kz = hux * hvy - huy * hvx
    kz = torch.where(torch.abs(kz) > KZ_EPS, kz, torch.full_like(kz, KZ_EPS))
    u = kx / kz
    v = ky / kz
    rho3d = u * u + v * v
    dx = X - means2d[None, :, 0]
    dy = Y - means2d[None, :, 1]
    rho2d = FILTER_INV_SQUARE_2DGS * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    z = M3[None, :, 0] * u + M3[None, :, 1] * v + M3[None, :, 2]
    alpha = torch.clamp_max(opacities[None, :] * torch.exp(-0.5 * rho),
                            MAX_ALPHA)
    alpha = torch.where((alpha >= ALPHA_CUTOFF) & (z > Z_MIN), alpha,
                        torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    T = torch.cat([torch.ones_like(alpha[:, :1]),
                   torch.cumprod(one_minus, dim=1)[:, :-1]], dim=1)
    w = torch.where(T > TRANSMITTANCE_EPS, alpha * T, torch.zeros_like(T))

    color_sum = w @ colors
    alpha_sum = w.sum(dim=1)
    wz = w * z
    depth_sum = wz.sum(dim=1)
    normal_sum = w @ normals
    T_final = torch.where(w > 0, one_minus, torch.ones_like(w)).prod(dim=1)
    # distortion (2DGS eq. 15, running form over the sorted order):
    # 2 Σ_i w_i (z_i A_{i-1} - D_{i-1}), A and D the prefix sums of w, w·z
    A_prev = torch.cumsum(w, dim=1) - w
    D_prev = torch.cumsum(wz, dim=1) - wz
    distort = 2.0 * torch.sum(w * (z * A_prev - D_prev), dim=1)
    # median depth: the depth of the first gaussian after which T < 0.5
    crossed = (T * one_minus < 0.5) & (w > 0)
    if crossed.shape[1] == 0:
        median = torch.zeros_like(alpha_sum)
    else:
        first = torch.argmax(crossed.int(), dim=1)
        median = torch.where(crossed.any(dim=1),
                             z.gather(1, first[:, None])[:, 0],
                             torch.zeros_like(alpha_sum))
    return (color_sum, alpha_sum, depth_sum, normal_sum, distort, median,
            T_final)


def render_dense_2dgs(
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    viewmat: torch.Tensor,
    K: torch.Tensor,
    width: int,
    height: int,
    background: torch.Tensor,
    sh_degree: Optional[int] = None,
    render_mode: str = "RGB",
    means2d_probe: Optional[torch.Tensor] = None,
):
    """2DGS oracle. Returns (render, alphas, normals, normals_from_depth,
    distort, median_depth, info), the JAX package's tuple: (H, W, C),
    (H, W, 1), (H, W, 3), (H, W, 3), (H, W, 1), (H, W, 1). Differentiable
    under autograd; `means2d_probe` as in `render_dense_3dgs` (it moves the
    low-pass term's centre only)."""
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    proj = project_2dgs(means, quats, scales, viewmat, K, width, height)
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_colors(colors, sh_degree, means, cam_pos)

    order = _depth_sorted(proj, opacities)
    s_tf = proj.transforms[order]
    s_means2d = proj.means2d[order]
    s_opac = opacities[order]
    s_rgb = rgb[order]
    s_normals = proj.normals[order]

    xs, ys = _pixel_centres(width, height, means.device)
    n_pix = height * width
    chunk = max(1, min(4096, _CHUNK_ELEMS // max(order.numel(), 1)))
    parts = [_composite_chunk_2dgs(xs[s:s + chunk], ys[s:s + chunk], s_tf,
                                   s_means2d, s_opac, s_rgb, s_normals)
             for s in range(0, n_pix, chunk)]
    (color_sum, alpha_sum, depth_sum, normal_sum, distort, median,
     T_final) = (torch.cat(p, dim=0) for p in zip(*parts))

    render = color_sum + T_final[:, None] * background[None, :]
    render = render.reshape(height, width, -1)
    alphas = alpha_sum.reshape(height, width, 1)
    normals = normal_sum.reshape(height, width, 3)
    distort = distort.reshape(height, width, 1)
    median = median.reshape(height, width, 1)
    if render_mode == "RGB+D":
        render = torch.cat([render, depth_sum.reshape(height, width, 1)],
                           dim=-1)
    elif render_mode == "RGB+ED":
        depth = depth_sum / torch.clamp_min(alpha_sum, 1e-10)
        render = torch.cat([render, depth.reshape(height, width, 1)], dim=-1)
    normals_from_depth = depth_to_normals(median[..., 0], K)
    info = {"radii": proj.radii, "means2d": proj.means2d,
            "depths": proj.depths}
    return render, alphas, normals, normals_from_depth, distort, median, info


def depth_to_normals(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-space normals of a depth map (H, W) by central differences
    -> (H, W, 3): zero on the border rows and columns, where the cross
    product vanishes and where the depth is not positive.

    The JAX package's `depth_to_normals` in value. Its gradient differs
    where that one's is not finite: it takes the norm as sqrt of Σn², whose
    derivative at n = 0 (every border pixel) is 0·inf = NaN, and one NaN
    cotangent of the median depth makes the whole 2DGS gradient NaN when
    the normal loss is on. Here the square root sits between two `where`s,
    so those pixels get the zero gradient of their zero normal."""
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device) + 0.5
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device) + 0.5
    px = (xs[None, :] - cx) / fx
    py = (ys[:, None] - cy) / fy
    pts = torch.stack([px * depth, py * depth, depth], dim=-1)  # (H, W, 3)
    zc = torch.zeros_like(pts[:, :1])
    zr = torch.zeros_like(pts[:1])
    ddx = torch.cat([zc, (pts[:, 2:] - pts[:, :-2]) * 0.5, zc], dim=1)
    ddy = torch.cat([zr, (pts[2:] - pts[:-2]) * 0.5, zr], dim=0)
    n = torch.stack([ddx[..., 1] * ddy[..., 2] - ddx[..., 2] * ddy[..., 1],
                     ddx[..., 2] * ddy[..., 0] - ddx[..., 0] * ddy[..., 2],
                     ddx[..., 0] * ddy[..., 1] - ddx[..., 1] * ddy[..., 0]],
                    dim=-1)
    sq = torch.sum(n * n, dim=-1, keepdim=True)
    ok = sq > 1e-16                                   # |n| > 1e-8
    norm = torch.sqrt(torch.where(ok, sq, torch.ones_like(sq)))
    n = torch.where(ok, n / norm, torch.zeros_like(n))
    return torch.where((depth > 0)[..., None], n, torch.zeros_like(n))
