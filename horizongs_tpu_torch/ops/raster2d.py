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
"""
from __future__ import annotations

import ctypes
import math

import torch

from horizongs_tpu_torch.kernels import CudaKernel
from horizongs_tpu_torch.ops.raster3d import (
    LOG_T_EPS,
    _check,
    _check_segments,
    _check_shape,
)
from horizongs_tpu_torch.ops.reference import (
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

_VP, _INT = ctypes.c_void_p, ctypes.c_int
KERNEL_2D = CudaKernel("raster2d_fwd",
                       [_VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP, _VP])
KERNEL_2D_BWD = CudaKernel("raster2d_bwd",
                           [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT,
                            _INT, _VP, _VP])


def local_pixel_coords(device):
    """Pixel centres inside a tile, (P,) x and (P,) y, row-major."""
    p = torch.arange(P, device=device)
    return (p % TILE_W).float() + 0.5, (p // TILE_W).float() + 0.5


def segment_geometry(f: torch.Tensor, t: int, n_tiles_x: int,
                     lx: torch.Tensor, ly: torch.Tensor) -> dict:
    """The ray-splat intersection of tile t's pixels (local centres lx, ly)
    with the surfels f (count, 18) of its segment, each a (P, count) tensor,
    in the kernels' order of products and sums: the alpha cut-offs fall
    where the kernels' do."""
    X = (lx + float((t % n_tiles_x) * TILE_W))[:, None]
    Y = (ly + float((t // n_tiles_x) * TILE_H))[:, None]
    M3x, M3y, M3z = f[None, :, 6], f[None, :, 7], f[None, :, 8]
    hu = (X * M3x - f[None, :, 0], X * M3y - f[None, :, 1],
          X * M3z - f[None, :, 2])
    hv = (Y * M3x - f[None, :, 3], Y * M3y - f[None, :, 4],
          Y * M3z - f[None, :, 5])
    kx = hu[1] * hv[2] - hu[2] * hv[1]
    ky = hu[2] * hv[0] - hu[0] * hv[2]
    kz = hu[0] * hv[1] - hu[1] * hv[0]
    kz_ok = torch.abs(kz) > KZ_EPS
    kzs = torch.where(kz_ok, kz, torch.full_like(kz, KZ_EPS))
    u = kx / kzs
    v = ky / kzs
    rho3d = u * u + v * v
    dx = X - f[None, :, 9]
    dy = Y - f[None, :, 10]
    rho2d = FILTER_INV_SQUARE_2DGS * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.where(use3d, rho3d, rho2d)
    z = M3x * u + M3y * v + M3z
    raw = f[None, :, 11] * torch.exp(-0.5 * rho)
    alpha = torch.clamp_max(raw, MAX_ALPHA)
    alpha = torch.where((alpha >= ALPHA_CUTOFF) & (z > Z_MIN), alpha,
                        torch.zeros_like(alpha))
    return dict(X=X, Y=Y, hu=hu, hv=hv, kz_ok=kz_ok, kzs=kzs, u=u, v=v,
                dx=dx, dy=dy, use3d=use3d, z=z, raw=raw, alpha=alpha)


def _suffix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the gaussian axis."""
    return torch.flip(torch.cumsum(torch.flip(x, [1]), 1), [1])


def rasterize2d_fwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                          tile_starts: torch.Tensor, n_tiles_x: int,
                          n_tiles_y: int):
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
        geo = segment_geometry(f, t, n_tiles_x, lx, ly)
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


def rasterize2d_fwd(fields: torch.Tensor, gauss_id: torch.Tensor,
                    tile_starts: torch.Tensor, n_tiles_x: int,
                    n_tiles_y: int):
    """K3 (see the module docstring): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (acc, aux, rec). `gauss_id`
    values and the monotonicity of `tile_starts` are the binning's
    guarantee and are not checked on the device."""
    dev = fields.device
    n_tiles = n_tiles_x * n_tiles_y
    _check_segments(fields, gauss_id, tile_starts, n_tiles, N_FIELDS)
    if dev.type == "cpu":
        return rasterize2d_fwd_plain(fields, gauss_id, tile_starts,
                                     n_tiles_x, n_tiles_y)
    acc = torch.empty((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    aux = torch.empty((n_tiles, N_AUX, P), dtype=torch.float32, device=dev)
    rec = torch.empty((n_tiles, 2, P), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return acc, aux, rec
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL_2D.launch(fields.data_ptr(), gauss_id.data_ptr(),
                         tile_starts.data_ptr(), n_tiles, n_tiles_x,
                         acc.data_ptr(), aux.data_ptr(), rec.data_ptr(),
                         stream)
    return acc, aux, rec


def rasterize2d_bwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                          tile_starts: torch.Tensor, d_acc: torch.Tensor,
                          d_aux: torch.Tensor, acc: torch.Tensor,
                          aux: torch.Tensor, rec: torch.Tensor,
                          n_tiles_x: int, n_tiles_y: int) -> torch.Tensor:
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
        geo = segment_geometry(f, t, n_tiles_x, lx, ly)
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


def rasterize2d_bwd(fields: torch.Tensor, gauss_id: torch.Tensor,
                    tile_starts: torch.Tensor, d_acc: torch.Tensor,
                    d_aux: torch.Tensor, acc: torch.Tensor, aux: torch.Tensor,
                    rec: torch.Tensor, n_tiles_x: int,
                    n_tiles_y: int) -> torch.Tensor:
    """K4 (see the module docstring): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns grad_fields (N, 18)."""
    dev = fields.device
    n_tiles = n_tiles_x * n_tiles_y
    _check_segments(fields, gauss_id, tile_starts, n_tiles, N_FIELDS)
    for name, x, dtype, shape in (
            ("d_acc", d_acc, torch.float32, (n_tiles, N_ACC, P)),
            ("d_aux", d_aux, torch.float32, (n_tiles, N_AUX, P)),
            ("acc", acc, torch.float32, (n_tiles, N_ACC, P)),
            ("aux", aux, torch.float32, (n_tiles, N_AUX, P)),
            ("rec", rec, torch.int32, (n_tiles, 2, P))):
        _check(name, x, dtype, len(shape), dev)
        _check_shape(name, x, shape)
    if dev.type == "cpu":
        return rasterize2d_bwd_plain(fields, gauss_id, tile_starts, d_acc,
                                     d_aux, acc, aux, rec, n_tiles_x,
                                     n_tiles_y)
    grad = torch.zeros_like(fields)
    if n_tiles == 0:
        return grad
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL_2D_BWD.launch(fields.data_ptr(), gauss_id.data_ptr(),
                             tile_starts.data_ptr(), d_acc.data_ptr(),
                             d_aux.data_ptr(), acc.data_ptr(),
                             aux.data_ptr(), rec.data_ptr(), n_tiles,
                             n_tiles_x, grad.data_ptr(), stream)
    return grad


def records_off_the_boundary(fields: torch.Tensor, gauss_id: torch.Tensor,
                             tile_starts: torch.Tensor, n_tiles_x: int,
                             rec_a: torch.Tensor, logT_a: torch.Tensor,
                             rec_b: torch.Tensor, logT_b: torch.Tensor):
    """(n_contrib, median) counts of pixels whose records differ between
    two runs of K3 (rec (n_tiles, 2, P), final log T (n_tiles, P)) other
    than at a boundary that rounding can move. Summed in another order, a
    pixel's log T may cross log 1e-4 (the stop) or log 0.5 (the median)
    one contributing gaussian later or earlier. So where n_contrib differs,
    both final log T must be at the stop (within 1e-4) and at most one
    gaussian between the two counts may have alpha >= 1/255; where the
    median's position differs, log T after the earlier one must lie within
    1e-4 of log 0.5 and no gaussian between the two (or after the one, if
    the other run found none) may contribute. (0, 0) means the runs agree."""
    lx, ly = local_pixel_coords(fields.device)
    starts = tile_starts.tolist()
    bad_nc = bad_med = 0
    for t, p in (rec_a[:, 0] != rec_b[:, 0]).nonzero().tolist():
        lo, hi = sorted((int(rec_a[t, 0, p]), int(rec_b[t, 0, p])))
        s = starts[t]
        alpha = segment_geometry(fields[gauss_id[s + lo:s + hi].long()], t,
                                 n_tiles_x, lx, ly)["alpha"][p]
        at_stop = (max(float(logT_a[t, p]), float(logT_b[t, p]))
                   <= LOG_T_EPS + 1e-4)
        bad_nc += int(not at_stop or int((alpha > 0).sum()) > 1)
    for t, p in (rec_a[:, 1] != rec_b[:, 1]).nonzero().tolist():
        pa, pb = int(rec_a[t, 1, p]), int(rec_b[t, 1, p])
        n = max(int(rec_a[t, 0, p]), int(rec_b[t, 0, p]))
        lo = min(x for x in (pa, pb) if x >= 0)
        hi = max(pa, pb) if min(pa, pb) >= 0 else n
        s = starts[t]
        alpha = segment_geometry(fields[gauss_id[s:s + n].long()], t,
                                 n_tiles_x, lx, ly)["alpha"][p]
        logT_after = torch.cumsum(torch.log1p(-alpha), 0)[lo]
        near = abs(float(logT_after) - LOG_HALF) <= 1e-4
        between = int((alpha[lo + 1:hi] > 0).sum())
        bad_med += int(not near or between > 0)
    return bad_nc, bad_med
