"""Dense oracle renderer: per-pixel alpha compositing over all gaussians.

The port's own small-scene reference, a straight-line PyTorch version of
the JAX package's `render_dense_3dgs`: gaussians sorted by depth, front to
back; sigma = ½ dᵀ Conic d; alpha = min(0.999, op·exp(-sigma)), dropped
below 1/255; a gaussian contributes iff the transmittance before it is
> 1e-4; color = Σ w_i c_i + T_final·background with w_i = alpha_i·T_i.
O(pixels × gaussians), so only gaussians that can contribute (radius > 0
and opacity at or above the cutoff, which no pixel's alpha can otherwise
reach) are composited, in pixel chunks that bound memory.
"""
from __future__ import annotations

from typing import Optional

import torch

from horizongs_tpu_torch.core.sh import eval_sh
from horizongs_tpu_torch.ops.projection import project_3dgs

ALPHA_CUTOFF = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999
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
):
    """Returns (render (H, W, C), alphas (H, W, 1), info dict)."""
    if render_mode not in ("RGB", "RGB+D", "RGB+ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    proj = project_3dgs(means, quats, scales, viewmat, K, width, height)
    cam_pos = torch.linalg.inv(viewmat)[:3, 3]
    rgb = _sh_colors(colors, sh_degree, means, cam_pos)

    keep = (proj.radii > 0) & (opacities >= ALPHA_CUTOFF)
    idx = torch.nonzero(keep).squeeze(1)
    # stable sort: equal depths keep their index order
    order = idx[torch.sort(proj.depths[idx], stable=True).indices]
    s_means2d = proj.means2d[order]
    s_conics = proj.conics[order]
    s_opac = opacities[order]
    s_rgb = rgb[order]
    s_depths = proj.depths[order]

    dev = means.device
    n_pix = height * width
    ys = (torch.arange(n_pix, device=dev) // width).float() + 0.5
    xs = (torch.arange(n_pix, device=dev) % width).float() + 0.5
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
