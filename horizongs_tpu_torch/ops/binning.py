"""Tile binning: gaussian -> (tile, depth)-sorted instance list.

The forward fields of the JAX package's `build_tile_instances`:
  1. per-gaussian tile span: with conics and opacities (3DGS) from the
     exact alpha-cutoff ellipse AABB, without them (2DGS) from the square
     around the cull circle; both lossless w.r.t. the compositor's cutoff;
  2. the span areas' inclusive prefix sum; each instance slot finds its
     gaussian with `searchsorted(offs, slot, right=True)` (the same count
     #(offs <= slot) as the JAX package's histogram + cumsum); the static
     capacity bounds memory, and overflow is dropped and counted;
  3. an exact rect-ellipse (3DGS) or rect-circle (2DGS) test prunes
     candidates;
  4. one stable sort on the int64 key tile << 32 | depth bits, the stable
     two-key `lax.sort` of the JAX package: ties (equal depths, as the ten
     zero-offset children of one anchor have) keep their slot order;
  5. per-tile segment starts by binary search over the sorted tile ids.
The gradient-routing fields (`inv_perm`, `out_starts`, `grad_slot`, ...)
have no counterpart: the backward kernels add each instance's gradient to
its gaussian's row themselves.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from horizongs_tpu_torch.ops.reference import ALPHA_CUTOFF


class TileInstances(NamedTuple):
    gauss_id: torch.Tensor     # (CAP,) int32 gaussian index per instance
    tile_id: torch.Tensor      # (CAP,) int32, == n_tiles for invalid slots
    valid: torch.Tensor        # (CAP,) bool
    n_instances: torch.Tensor  # () int32 true instance count (pre-drop)
    n_dropped: torch.Tensor    # () int32 instances beyond CAP
    tile_starts: torch.Tensor  # (n_tiles+1,) int32 segment offsets


def tile_spans(means2d: torch.Tensor, rx: torch.Tensor, ry: torch.Tensor,
               n_tiles_x: int, n_tiles_y: int, tile_w: int, tile_h: int):
    """Inclusive tile index ranges covered by each gaussian's AABB."""
    x0 = torch.floor((means2d[:, 0] - rx) / tile_w).int()
    x1 = torch.floor((means2d[:, 0] + rx) / tile_w).int()
    y0 = torch.floor((means2d[:, 1] - ry) / tile_h).int()
    y1 = torch.floor((means2d[:, 1] + ry) / tile_h).int()
    return (x0.clamp(0, n_tiles_x - 1), x1.clamp(0, n_tiles_x - 1),
            y0.clamp(0, n_tiles_y - 1), y1.clamp(0, n_tiles_y - 1))


def ellipse_extents(conics: torch.Tensor, opacities: torch.Tensor):
    """Per-axis half-extents of the alpha >= cutoff region and its sigma
    threshold tau = ln(op/cutoff): the ellipse ½dᵀQd <= tau has AABB
    half-extents sqrt(2·tau·c/det), sqrt(2·tau·a/det)."""
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    tau = torch.log(torch.clamp_min(opacities, 1e-12) / ALPHA_CUTOFF)
    tau = torch.clamp_min(tau, 0.0)
    det = torch.clamp_min(a * c - b * b, 1e-12)
    rx = torch.sqrt(2.0 * tau * c / det)
    ry = torch.sqrt(2.0 * tau * a / det)
    return rx, ry, tau


def cull_radius(radii: torch.Tensor, opacities: torch.Tensor,
                guard_px: float = 0.0) -> torch.Tensor:
    """Opacity-exact cull radius r·sqrt(2·ln(op/cutoff))/3 (r = 3σ_max):
    beyond it alpha is below the compositor's cutoff, so binning against it
    is lossless. `guard_px`: a splat whose radius is below it is never
    shrunk below its geometric radius (the 2DGS low-pass bound 2·d² >= s²
    needs r >= ~2.2 px for the argument to hold). The square root sits
    between two `where`s so that its gradient stays finite where
    op <= cutoff."""
    inner = 2.0 * torch.log(torch.clamp_min(opacities, 1e-12) / ALPHA_CUTOFF)
    pos = inner > 0
    s = torch.where(pos, torch.sqrt(torch.where(pos, inner,
                                                torch.ones_like(inner))),
                    torch.zeros_like(inner))
    factor = s / 3.0
    if guard_px > 0:
        factor = torch.where(radii >= guard_px, factor,
                             torch.clamp_min(factor, 1.0))
    return radii * factor


def _spans(means2d, radii, conics, opacities, n_tiles_x, n_tiles_y,
           tile_w, tile_h):
    """(x0, x1, y0, y1, n_cover, tau) of every gaussian; tau is None on the
    circle path (no conics)."""
    valid_g = radii > 0
    if conics is not None:
        rx, ry, tau = ellipse_extents(conics, opacities)
        zero = torch.zeros_like(rx)
        rx = torch.where(valid_g, rx, zero)
        ry = torch.where(valid_g, ry, zero)
    else:
        rx = ry = radii
        tau = None
    x0, x1, y0, y1 = tile_spans(means2d, rx, ry, n_tiles_x, n_tiles_y,
                                tile_w, tile_h)
    n_cover = torch.where(valid_g, (x1 - x0 + 1) * (y1 - y0 + 1),
                          torch.zeros_like(x0))
    return x0, x1, y0, y1, n_cover, tau


def count_tile_instances(means2d: torch.Tensor, radii: torch.Tensor,
                         n_tiles_x: int, n_tiles_y: int,
                         tile_w: int, tile_h: int,
                         conics: Optional[torch.Tensor] = None,
                         opacities: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Instance slots the AABB spans enumerate: the capacity
    `build_tile_instances` needs for the same arguments."""
    n_cover = _spans(means2d, radii, conics, opacities, n_tiles_x,
                     n_tiles_y, tile_w, tile_h)[4]
    return n_cover.sum()


def _rect_ellipse_hit(conics, tau, mx, my, rx0, ry0, tile_w, tile_h):
    """Exact rect-ellipse test: min over the tile rectangle of sigma =
    ½(a·dx² + 2b·dx·dy + c·dy²) against tau. It is 0 when the centre is
    inside; otherwise it lies on an edge, at the 1D minimizer clamped to
    the edge's range."""
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    xlo, xhi = rx0 - mx, rx0 + tile_w - mx
    ylo, yhi = ry0 - my, ry0 + tile_h - my

    def quad(dx, dy):
        return 0.5 * a * dx * dx + b * dx * dy + 0.5 * c * dy * dy

    def edge_x(X):
        ys = torch.minimum(torch.maximum(
            -b * X / torch.clamp_min(c, 1e-12), ylo), yhi)
        return quad(X, ys)

    def edge_y(Y):
        xs = torch.minimum(torch.maximum(
            -b * Y / torch.clamp_min(a, 1e-12), xlo), xhi)
        return quad(xs, Y)

    qmin = torch.minimum(torch.minimum(edge_x(xlo), edge_x(xhi)),
                         torch.minimum(edge_y(ylo), edge_y(yhi)))
    inside = (xlo <= 0) & (xhi >= 0) & (ylo <= 0) & (yhi >= 0)
    qmin = torch.where(inside, torch.zeros_like(qmin), qmin)
    # sigma slack for f32 roundoff between this test and the kernel's
    # alpha (a borderline splat is worth <= cutoff alpha)
    return qmin <= tau + 1e-3


def build_tile_instances(means2d: torch.Tensor, radii: torch.Tensor,
                         depths: torch.Tensor, n_tiles_x: int,
                         n_tiles_y: int, tile_w: int, tile_h: int, cap: int,
                         conics: Optional[torch.Tensor] = None,
                         opacities: Optional[torch.Tensor] = None
                         ) -> TileInstances:
    """Gaussians with radius > 0 (`cull_radius`) -> the (tile, depth)-
    sorted instance list of at most `cap` slots. With `conics` and
    `opacities` (3DGS) spans and the pruning test follow the alpha-cutoff
    ellipse; without them (2DGS) the circle of radius `radii`."""
    dev = means2d.device
    n_tiles = n_tiles_x * n_tiles_y
    N = means2d.shape[0]
    x0, x1, y0, y1, n_cover, tau = _spans(
        means2d, radii, conics, opacities, n_tiles_x, n_tiles_y, tile_w,
        tile_h)
    wspan = x1 - x0 + 1

    offs = torch.cumsum(n_cover, dim=0, dtype=torch.int64)  # inclusive
    total = offs[-1]
    slots = torch.arange(cap, dtype=torch.int64, device=dev)
    g = torch.searchsorted(offs, slots, right=True).clamp_max(N - 1)

    start = offs[g] - n_cover[g].long()
    local = slots - start
    w = torch.clamp_min(wspan[g].long(), 1)
    q = torch.div(local, w, rounding_mode="floor")
    tx = x0[g].long() + (local - q * w)
    ty = y0[g].long() + q
    valid_slot = slots < total
    mx, my = means2d[g, 0], means2d[g, 1]
    rx0 = (tx * tile_w).float()
    ry0 = (ty * tile_h).float()
    if conics is not None:
        hit = _rect_ellipse_hit(conics[g], tau[g], mx, my, rx0, ry0,
                                tile_w, tile_h)
    else:
        # exact rect-circle test: the distance from the tile rectangle to
        # the centre against the cull radius (the square span keeps corner
        # tiles the circle never touches)
        r = radii[g]
        ddx = mx - torch.minimum(torch.maximum(mx, rx0), rx0 + tile_w)
        ddy = my - torch.minimum(torch.maximum(my, ry0), ry0 + tile_h)
        hit = (ddx * ddx + ddy * ddy) <= r * r
    valid_slot = valid_slot & hit
    tile_id = torch.where(valid_slot, ty * n_tiles_x + tx,
                          torch.full_like(ty, n_tiles))

    # (tile, depth) key: the f32 depth bits compared as signed int32, as
    # the JAX package's sort compares them; adding 2^31 maps that order
    # onto the unsigned low word
    depth_bits = depths.float().contiguous().view(torch.int32)[g].long()
    key = (tile_id << 32) | (depth_bits + (1 << 31))
    perm = torch.sort(key, stable=True).indices
    tile_sorted = tile_id[perm]
    g_sorted = g[perm]

    tile_starts = torch.searchsorted(
        tile_sorted, torch.arange(n_tiles + 1, dtype=torch.int64, device=dev),
        right=False)

    return TileInstances(gauss_id=g_sorted.int(),
                         tile_id=tile_sorted.int(),
                         valid=tile_sorted < n_tiles,
                         n_instances=total.int(),
                         n_dropped=torch.clamp_min(total - cap, 0).int(),
                         tile_starts=tile_starts.int())
