# Frozen copy of horizongs_tpu_torch/ops/raster2d.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""K3 and K4: 2DGS (surfel) compositing of each tile's depth-sorted instance
segment by ray-splat intersection, front to back (K3), and its reverse walk
for the gradients (K4).

`rasterize2d_fwd` launches the CUDA kernel `csrc/raster2d_fwd.cu` and
`rasterize2d_bwd` the kernel `csrc/raster2d_bwd.cu` for CUDA tensors; for
CPU tensors they run `rasterize2d_fwd_plain` and `rasterize2d_bwd_plain`,
the same functions in plain PyTorch. The kernels replace the Pallas TPU
kernels `horizongs_tpu/ops/pallas/raster2d.py::_fwd_kernel` and
`_bwd_kernel`; their sources say what bounds them on Hopper and how their
designs meet that.

For pixel (px, py) and a surfel with fields f, in the kernels' order:
  hu = px·M3 - M1, hv = py·M3 - M2, k = hu × hv,
  kz' = k_z if |k_z| > 1e-9 else 1e-9, (u, v) = (k_x, k_y) / kz',
  rho = min(u² + v², 2·((px - mx)² + (py - my)²)), z = M3·(u, v, 1),
  alpha = min(op·exp(-rho/2), 0.999), dropped below 1/255 and where
  z <= 0.01; w = alpha·T while log T before the gaussian > log 1e-4.

K3's contract:
  fields      (N, 18) float32: M1 (3), M2 (3), M3 (3), mx, my, opacity,
              r, g, b, normal (3)
  gauss_id    (CAP,) int32 gaussian of each sorted instance
  tile_starts (n_tiles+1,) int32: tile t's segment is
              [tile_starts[t], tile_starts[t+1]), depth-sorted
  -> acc (n_tiles, 7, P) float32: Σw·(r, g, b, nx, ny, nz) and alpha = Σw
          (A, the distortion's total weight)
     aux (n_tiles, 4, P) float32: final log T, D = Σw·z, the distortion
          2·Σ_i w_i·(z_i·A_{i-1} - D_{i-1}) (2DGS eq. 15), the median depth
          (z of the gaussian after which T < 0.5; 0 if none)
     rec (n_tiles, 2, P) int32: n_contrib, the gaussians of its segment each
          pixel walked before it stopped (log T at or below log 1e-4) — the
          one that stopped it included — or the segment's length; and the
          median gaussian's position in the segment (-1 if none).
K4's contract: the same fields, gauss_id and tile_starts, the cotangents
d_acc (n_tiles, 7, P) and d_aux (n_tiles, 4, P) of K3's acc and aux, and
K3's acc, aux and rec -> grad_fields (N, 18), the gradient of every
gaussian's fields summed over its instances. Each pixel's reverse walk
starts at its own n_contrib; the median's cotangent goes to the dz of
exactly the gaussian at its recorded position. Gaussians that no pixel
walked get exactly zero.
Tiles are 32x16 (P = 512 pixels, row-major), as the TPU kernels' (so
instance counts and capacities match the JAX package's), tile t at column
t % n_tiles_x, row t // n_tiles_x.

Unlike the TPU kernel, which walks until every pixel of the tile stopped
and keeps adding log1p(-alpha) to a stopped pixel's log T, each pixel stops
on its own, as the dense oracle does; where a pixel stops the two differ by
bg·T below 1e-4. The median is crossed in log space (log T after the
gaussian < log 0.5), which saves the kernels an exp per contributing pair.

Inside a tile's block, warp w owns the 8x8 pixel block at column 8·(w % 4),
row 8·(w // 4) (`warp_of_pixel`). Both kernels skip work that provably has
alpha = 0 (`csrc/raster2d_common.cuh`): a warp skips a surfel whose support
box its pixel centres miss (`support_box`, `warp_cull`), and a pair that a
division-free test rejects (`segment_reject`) skips the exact intersection.
Every other pair takes the exact intersection, so records and cut-offs are
those of `segment_geometry`. These plain copies of the two tests, with
`skip_threshold`, serve the tests and the chip run's counters only. K3
stages its batches with cp.async, 8-byte copies of the field rows: the
kernel's `fields` must be 8-byte aligned.
"""
from __future__ import annotations

import math

import torch

from hgsbench.reference.raster3d import LOG_T_EPS
from hgsbench.reference.dense import (
    ALPHA_CUTOFF,
    FILTER_INV_SQUARE_2DGS,
    KZ_EPS,
    MAX_ALPHA,
    Z_MIN,
)

TILE_W = 32
TILE_H = 16
P = TILE_W * TILE_H
G = 128          # the JAX package's chunk: capacities are G-aligned
N_FIELDS = 18
N_ACC = 7        # acc rows: r, g, b, nx, ny, nz, alpha
N_AUX = 4        # aux rows: log T, D, distortion, median depth
LOG_HALF = math.log(0.5)

# the margins of the rejection and the support box, and the warp map: copies
# of csrc/raster2d_common.cuh's constants, which derives them
# (tests/test_torch_raster2d.py holds the two equal)
REJECT_REL = 1e-5
REJECT_ABS = 1e-5
BOX_RHO_SCALE = 1.001
BOX_PAD_PX = 1.0
BOX_PAD_REL = 1e-4
WARPS = 8
BLOCK_PX = 8
FLT_MAX = torch.finfo(torch.float32).max

def local_pixel_coords(device):
    """Pixel centres inside a tile, (P,) x and (P,) y, row-major."""
    p = torch.arange(P, device=device)
    return (p % TILE_W).float() + 0.5, (p // TILE_W).float() + 0.5


def warp_of_pixel(device) -> torch.Tensor:
    """(P,) the warp of K3's and K4's blocks that owns each pixel."""
    p = torch.arange(P, device=device)
    return (p // TILE_W // BLOCK_PX) * (TILE_W // BLOCK_PX) \
        + (p % TILE_W) // BLOCK_PX


def skip_threshold(op: torch.Tensor) -> torch.Tensor:
    """thr per surfel, float32 as the kernels compute it (to within an ulp
    of the log): 2 ln(255 op) widened by REJECT_REL of itself and by
    REJECT_ABS; -1 where the surfel reaches alpha 1/255 at no pixel."""
    tau = 2.0 * torch.log(255.0 * op)
    thr = tau + REJECT_REL * torch.abs(tau) + REJECT_ABS
    thr = torch.where(thr < 0.5 * REJECT_ABS, torch.full_like(thr, -1.0), thr)
    return torch.where(op <= 0, torch.full_like(thr, -1.0), thr)


def segment_reject(f: torch.Tensor, t: int, n_tiles_x: int,
                   lx: torch.Tensor, ly: torch.Tensor,
                   row0: int = 0) -> torch.Tensor:
    """(P, count) bool: the pairs of tile t's pixels and the surfels f
    (count, 18) that the kernels' division-free test skips, in their order
    of rounded operations: rho2d > thr and kx² + ky² > thr·kz'² with a
    finite left side. A skipped pair has alpha = 0."""
    h = _hit_terms(f, t, n_tiles_x, lx, ly, row0)
    kx, ky, kz = h["kx"], h["ky"], h["kz"]
    thr = skip_threshold(f[:, 11])[None, :]
    kzs = torch.where(torch.abs(kz) > KZ_EPS, kz, torch.full_like(kz, KZ_EPS))
    a = kx * kx + ky * ky
    b = thr * (kzs * kzs)
    return (h["rho2d"] > thr) & (a <= FLT_MAX) & (a > b)


def support_box(f: torch.Tensor) -> torch.Tensor:
    """(count, 4) float32 (x0, x1, y0, y1): pixel centres outside
    [x0, x1] x [y0, y1] have alpha = 0 with the surfels f (count, 18). The
    kernels' double-precision box of the disk u² + v² <= 1.001·thr mapped
    through M, united with the low-pass circle and widened (to the last
    bits of a double); the whole plane where that disk is not wholly in
    front of the camera, where a half extent² <= 0 or where anything is not
    finite; empty where thr < 0."""
    thr = skip_threshold(f[:, 11])
    m = f[:, :11].double()
    t = BOX_RHO_SCALE * thr.double()
    m1x, m1y, m1z, m2x, m2y, m2z, m3x, m3y, m3z, mx, my = m.unbind(1)
    d = t * (m3x * m3x + m3y * m3y) - m3z * m3z
    front = (m3z > 0) & (d < 0)
    d = torch.where(front, d, torch.full_like(d, -1.0))
    cx = (t * (m1x * m3x + m1y * m3y) - m1z * m3z) / d
    cy = (t * (m2x * m3x + m2y * m3y) - m2z * m3z) / d
    hx2 = cx * cx - (t * (m1x * m1x + m1y * m1y) - m1z * m1z) / d
    hy2 = cy * cy - (t * (m2x * m2x + m2y * m2y) - m2z * m2z) / d
    ok = front & (hx2 > 0) & (hy2 > 0)
    hx = torch.sqrt(torch.clamp_min(hx2, 0.0))
    hy = torch.sqrt(torch.clamp_min(hy2, 0.0))
    r = torch.sqrt(torch.clamp_min(0.5 * t, 0.0))
    px = BOX_PAD_PX + BOX_PAD_REL * (torch.abs(cx) + hx)
    py = BOX_PAD_PX + BOX_PAD_REL * (torch.abs(cy) + hy)
    qx = BOX_PAD_PX + BOX_PAD_REL * (torch.abs(mx) + r)
    qy = BOX_PAD_PX + BOX_PAD_REL * (torch.abs(my) + r)
    box = torch.stack([torch.minimum(cx - hx - px, mx - r - qx),
                       torch.maximum(cx + hx + px, mx + r + qx),
                       torch.minimum(cy - hy - py, my - r - qy),
                       torch.maximum(cy + hy + py, my + r + qy)], 1).float()
    ok &= (box.abs() <= FLT_MAX).all(1)
    inf = math.inf
    whole = torch.tensor([-inf, inf, -inf, inf], device=f.device)
    box = torch.where(ok[:, None], box, whole)
    empty = torch.tensor([inf, -inf, inf, -inf], device=f.device)
    return torch.where((thr < 0)[:, None], empty, box)


def warp_cull(f: torch.Tensor, t: int, n_tiles_x: int,
              row0: int = 0) -> torch.Tensor:
    """(WARPS, count) bool: warp w of tile t's block skips surfel j of f
    (count, 18) outright, its pixel centres all outside the support box."""
    box = support_box(f)
    w = torch.arange(WARPS, device=f.device)
    xl = (float((t % n_tiles_x) * TILE_W) + (w % 4 * BLOCK_PX).float()
          + 0.5)[:, None]
    yl = (float((t // n_tiles_x) * TILE_H + row0)
          + (w // 4 * BLOCK_PX).float() + 0.5)[:, None]
    xh, yh = xl + (BLOCK_PX - 1), yl + (BLOCK_PX - 1)
    return ((box[None, :, 1] < xl) | (box[None, :, 0] > xh)
            | (box[None, :, 3] < yl) | (box[None, :, 2] > yh))


def _hit_terms(f: torch.Tensor, t: int, n_tiles_x: int,
               lx: torch.Tensor, ly: torch.Tensor, row0: int = 0) -> dict:
    """The division-free part of the intersection of tile t's pixels with
    the surfels f (count, 18), each a (P, count) tensor, in the kernels'
    order of products and sums: X, Y, hu, hv, k = hu x hv, dx, dy, rho2d.
    Pixel rows start at `row0`."""
    X = (lx + float((t % n_tiles_x) * TILE_W))[:, None]
    Y = (ly + float((t // n_tiles_x) * TILE_H + row0))[:, None]
    M3x, M3y, M3z = f[None, :, 6], f[None, :, 7], f[None, :, 8]
    hu = (X * M3x - f[None, :, 0], X * M3y - f[None, :, 1],
          X * M3z - f[None, :, 2])
    hv = (Y * M3x - f[None, :, 3], Y * M3y - f[None, :, 4],
          Y * M3z - f[None, :, 5])
    kx = hu[1] * hv[2] - hu[2] * hv[1]
    ky = hu[2] * hv[0] - hu[0] * hv[2]
    kz = hu[0] * hv[1] - hu[1] * hv[0]
    dx = X - f[None, :, 9]
    dy = Y - f[None, :, 10]
    rho2d = FILTER_INV_SQUARE_2DGS * (dx * dx + dy * dy)
    return dict(X=X, Y=Y, hu=hu, hv=hv, kx=kx, ky=ky, kz=kz, dx=dx, dy=dy,
                rho2d=rho2d)


def segment_geometry(f: torch.Tensor, t: int, n_tiles_x: int,
                     lx: torch.Tensor, ly: torch.Tensor,
                     row0: int = 0) -> dict:
    """The ray-splat intersection of tile t's pixels (local centres lx, ly)
    with the surfels f (count, 18) of its segment, each a (P, count) tensor,
    in the kernels' order of products and sums: the alpha cut-offs fall
    where the kernels' do. Pixel rows start at `row0`."""
    h = _hit_terms(f, t, n_tiles_x, lx, ly, row0)
    M3x, M3y, M3z = f[None, :, 6], f[None, :, 7], f[None, :, 8]
    kz = h["kz"]
    kz_ok = torch.abs(kz) > KZ_EPS
    kzs = torch.where(kz_ok, kz, torch.full_like(kz, KZ_EPS))
    u = h["kx"] / kzs
    v = h["ky"] / kzs
    rho3d = u * u + v * v
    rho2d = h["rho2d"]
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    z = M3x * u + M3y * v + M3z
    raw = f[None, :, 11] * torch.exp(-0.5 * rho)
    alpha = torch.clamp_max(raw, MAX_ALPHA)
    alpha = torch.where((alpha >= ALPHA_CUTOFF) & (z > Z_MIN), alpha,
                        torch.zeros_like(alpha))
    return dict(X=h["X"], Y=h["Y"], hu=h["hu"], hv=h["hv"], kz_ok=kz_ok,
                kzs=kzs, u=u, v=v, dx=h["dx"], dy=h["dy"], use3d=use3d, z=z,
                raw=raw, alpha=alpha)


def _suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the gaussian axis."""
    return torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])


def rasterize2d_fwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                          tile_starts: torch.Tensor, n_tiles_x: int,
                          n_tiles_y: int, row0: int = 0):
    """Plain PyTorch K3, tile by tile: a (P, count) alpha matrix, log T
    before each gaussian as an exclusive cumsum of log1p(-alpha), the w
    mask, and the distortion's prefix sums A, D by cumsum — the dense
    oracle's arithmetic restricted to the segment, in log space."""
    n_tiles = n_tiles_x * n_tiles_y
    dev = fields.device
    acc = torch.zeros((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    aux = torch.zeros((n_tiles, N_AUX, P), dtype=torch.float32, device=dev)
    rec = torch.zeros((n_tiles, 2, P), dtype=torch.int32, device=dev)
    rec[:, 1] = -1
    lx, ly = local_pixel_coords(dev)
    starts = tile_starts.tolist()
    for t in range(n_tiles):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        f = fields[gauss_id[s:e].long()]                    # (count, 18)
        geo = segment_geometry(f, t, n_tiles_x, lx, ly, row0)
        alpha, z = geo["alpha"], geo["z"]
        lam = torch.log1p(-alpha)
        incl = torch.cumsum(lam, dim=1)
        excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
        live = excl > LOG_T_EPS                             # a prefix per pixel
        zero = torch.zeros_like(alpha)
        w = torch.where(live, alpha * torch.exp(excl), zero)
        wz = torch.where(w > 0, w * z, zero)
        acc[t, 0:3] = (w @ f[:, 12:15]).T
        acc[t, 3:6] = (w @ f[:, 15:18]).T
        acc[t, 6] = w.sum(dim=1)
        A_prev = torch.cumsum(w, dim=1) - w
        D_prev = torch.cumsum(wz, dim=1) - wz
        aux[t, 1] = wz.sum(dim=1)
        aux[t, 2] = 2.0 * torch.sum(
            torch.where(w > 0, w * (z * A_prev - D_prev), zero), dim=1)
        n_live = live.sum(dim=1)                            # >= 1
        aux[t, 0] = incl.gather(1, (n_live - 1)[:, None])[:, 0]
        crossed = (incl < LOG_HALF) & (w > 0)
        first = torch.argmax(crossed.int(), dim=1)
        any_ = crossed.any(dim=1)
        aux[t, 3] = torch.where(any_, z.gather(1, first[:, None])[:, 0],
                                torch.zeros_like(aux[t, 3]))
        rec[t, 0] = n_live.int()
        rec[t, 1] = torch.where(any_, first, torch.full_like(first, -1)).int()
    return acc, aux, rec


def rasterize2d_bwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                          tile_starts: torch.Tensor, d_acc: torch.Tensor,
                          d_aux: torch.Tensor, acc: torch.Tensor,
                          aux: torch.Tensor, rec: torch.Tensor,
                          n_tiles_x: int, n_tiles_y: int,
                          row0: int = 0) -> torch.Tensor:
    """Plain PyTorch K4, tile by tile, in closed form (no autograd): each
    pixel's log T before every gaussian it walked is rebuilt from its final
    log T by a suffix sum of log1p(-alpha) over [j, n_contrib); S_after and
    the strict suffixes A_suf, D_suf are suffix sums; A_prev and D_prev are
    the totals less those suffixes, as the kernel forms them. The
    per-instance gradients are column sums over the tile's pixels, added to
    the gaussians' rows."""
    grad = torch.zeros_like(fields)
    dev = fields.device
    lx, ly = local_pixel_coords(dev)
    starts = tile_starts.tolist()
    for t in range(n_tiles_x * n_tiles_y):
        s, e = starts[t], starts[t + 1]
        count = e - s
        if count == 0:
            continue
        ids = gauss_id[s:e].long()
        f = fields[ids]                                      # (count, 18)
        geo = segment_geometry(f, t, n_tiles_x, lx, ly, row0)
        pos = torch.arange(count, device=dev)[None, :]
        zero = torch.zeros_like(geo["alpha"])
        alpha = torch.where(pos < rec[t, 0][:, None], geo["alpha"], zero)
        contrib = alpha > 0
        z = torch.where(contrib, geo["z"], zero)
        u = torch.where(contrib, geo["u"], zero)
        v = torch.where(contrib, geo["v"], zero)
        lam = torch.log1p(-alpha)
        w = alpha * torch.exp(aux[t, 0][:, None] - _suffix(lam))
        wz = w * z
        A_suf = _suffix(w) - w                               # strict suffixes
        D_suf = _suffix(wz) - wz
        A_prev = acc[t, 6][:, None] - A_suf - w
        D_prev = aux[t, 1][:, None] - D_suf - wz
        g = d_acc[t]                                         # (7, P)
        d_logT, d_D, d_dist, d_med = (d_aux[t, r][:, None] for r in range(4))
        dw = (g[0:3].T @ f[:, 12:15].T + g[3:6].T @ f[:, 15:18].T
              + g[6][:, None] + d_D * z
              + d_dist * 2.0 * ((z * A_prev - D_prev) + (D_suf - z * A_suf)))
        median = (pos == rec[t, 1][:, None]).float()
        dz = d_D * w + d_dist * 2.0 * w * (A_prev - A_suf) + d_med * median
        wdw = w * dw
        S_after = d_logT + _suffix(wdw) - wdw
        gate = contrib & (geo["raw"] < MAX_ALPHA)
        adalpha = torch.where(gate, wdw - S_after * (alpha / (1.0 - alpha)),
                              zero)
        drho = -0.5 * adalpha
        use3d = geo["use3d"]
        M3x, M3y = f[None, :, 6], f[None, :, 7]
        du = torch.where(use3d, 2.0 * u * drho, zero) + dz * M3x
        dv = torch.where(use3d, 2.0 * v * drho, zero) + dz * M3y
        c = 2.0 * FILTER_INV_SQUARE_2DGS
        ddx = torch.where(use3d, zero, c * geo["dx"] * drho)
        ddy = torch.where(use3d, zero, c * geo["dy"] * drho)
        kzs = geo["kzs"]
        dkx = du / kzs
        dky = dv / kzs
        dkz = torch.where(geo["kz_ok"], -(u * du + v * dv) / kzs, zero)
        hux, huy, huz = geo["hu"]
        hvx, hvy, hvz = geo["hv"]
        # k = hu x hv: d_hu = hv x dk, d_hv = dk x hu
        dhux = hvy * dkz - hvz * dky
        dhuy = hvz * dkx - hvx * dkz
        dhuz = hvx * dky - hvy * dkx
        dhvx = dky * huz - dkz * huy
        dhvy = dkz * hux - dkx * huz
        dhvz = dkx * huy - dky * hux
        X, Y = geo["X"], geo["Y"]
        op = f[:, 11]
        sa = adalpha.sum(0)
        gop = torch.where(op > 0, sa / torch.clamp_min(op, 1e-12),
                          torch.zeros_like(sa))
        per_inst = torch.stack([
            -dhux.sum(0), -dhuy.sum(0), -dhuz.sum(0),
            -dhvx.sum(0), -dhvy.sum(0), -dhvz.sum(0),
            (X * dhux + Y * dhvx + dz * u).sum(0),
            (X * dhuy + Y * dhvy + dz * v).sum(0),
            (X * dhuz + Y * dhvz + dz).sum(0),
            -ddx.sum(0), -ddy.sum(0), gop], dim=1)
        per_inst = torch.cat([per_inst, (g[0:6] @ w).T], dim=1)  # (count, 18)
        grad.index_add_(0, ids, per_inst)
    return grad


# the reference runs the plain versions wherever the tensors are
rasterize2d_fwd = rasterize2d_fwd_plain
rasterize2d_bwd = rasterize2d_bwd_plain
