"""K1 and K2: 3DGS compositing of each tile's depth-sorted instance
segment, front to back (K1) and its reverse walk for the gradients (K2).

`rasterize_fwd` launches the CUDA kernel `csrc/raster3d_fwd.cu` and
`rasterize_bwd` the kernel `csrc/raster3d_bwd.cu` for CUDA tensors; for CPU
tensors they run `rasterize_fwd_plain` and `rasterize_bwd_plain`, the same
functions in plain PyTorch. The kernels replace the Pallas TPU kernels
`horizongs_tpu/ops/pallas/raster3d.py::_fwd_kernel` and `_bwd_kernel`;
their sources say what bounds them on Hopper and how their designs meet
that.

K1's contract (the TPU kernel's, minus the instance copy it needed):
  fields      (N, 10) float32: mx, my, conic a, b, c, opacity, r, g, b, depth
  gauss_id    (CAP,) int32 gaussian of each sorted instance
  tile_starts (n_tiles+1,) int32: tile t's segment is
              [tile_starts[t], tile_starts[t+1]), depth-sorted
  -> acc  (n_tiles, 5, P) float32: rows r, g, b, depth, alpha (the TPU
          kernel's acc rows 6-10)
     logT (n_tiles, 2, P) float32: row 0 the final log transmittance, row 1
          i_fin, the number of G-gaussian chunks the tile's walk reached
          before all its pixels stopped (0 for an empty tile)
     n_contrib (n_tiles, P) int32: the gaussians of its segment each pixel
          walked before it stopped (log T at or below log 1e-4) — the
          one that stopped it included — or the segment's length. The
          final log T holds exactly these gaussians' log1p(-alpha).
K2's contract: the same fields, gauss_id and tile_starts, the cotangents
d_acc (n_tiles, 5, P) and d_logT (n_tiles, P) of K1's acc and final log T,
that final log T (n_tiles, P) and n_contrib -> grad_fields (N, 10), the
gradient of every gaussian's fields, summed over its instances. Each
pixel's reverse walk starts at its own n_contrib: a tile-wide start
(i_fin) would subtract from a stopped pixel's log T gaussians it never
added. Gaussians that no pixel walked get exactly zero.
Tiles are 32x32 (P = 1024 pixels, row-major), tile t at column
t % n_tiles_x, row t // n_tiles_x.

Inside a tile's block, warp w owns the 8x8 pixel block at column
8·(w % 4), row 8·(w // 4) (`warp_of_pixel`). Both kernels skip work that
provably has alpha = 0 (`csrc/raster3d_common.cuh`, which derives the
margins): a warp skips a gaussian whose support box its pixel centres miss
(`support_box`, `warp_cull`), and a pair whose rounded sigma exceeds the
gaussian's threshold (`skip_threshold`, `segment_reject`) skips the exp.
Every other pair takes the unchanged arithmetic, so records and cut-offs
are those of the plain versions. These plain copies of the tests serve the
tests and the chip run's counters only. The kernels stage their chunks
with cp.async, 8-byte copies of the field rows: the kernels' `fields`
must be 8-byte aligned.

Two measurement tools live beside them. T1, `rasterize_fwd_persistent`
(`csrc/raster3d_fwd_persistent.cu`, the counterpart of the Pallas tool
`tools/experiment_fused_fwd.py::rasterize_fwd_fused`), computes K1's
function bit for bit with persistent blocks that take tiles in a static or
a dynamic schedule. T2, `rasterize_bwd_variant` (`csrc/raster3d_bwd.cu`
built with `-DK2_VARIANT=<n>`, the counterpart of
`tools/profile_bwd_variants.py::make_bwd`), runs K2 with parts removed to
attribute its time, each variant held to K2's blocks per SM
(`variant_occupancy`); the stripped variants compute nothing a caller
uses.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from horizongs_tpu_torch.kernels import CudaKernel
from horizongs_tpu_torch.ops.reference import (
    ALPHA_CUTOFF,
    MAX_ALPHA,
    TRANSMITTANCE_EPS,
)

TILE_W = 32
TILE_H = 32
P = TILE_W * TILE_H
G = 128          # gaussians per chunk: the unit of i_fin
N_FIELDS = 10
N_ACC = 5        # acc rows: r, g, b, depth, alpha
LOG_T_EPS = math.log(TRANSMITTANCE_EPS)

# the margins of the rejection and the support box, and the warp map: copies
# of csrc/raster3d_common.cuh's constants, which derives them
# (tests/test_torch_raster3d_skip.py holds the two equal)
REJECT_REL = 1e-5
REJECT_ABS = 1e-5
THR_FLOOR = -80.0
BOX_RHO_SCALE = 1.001
BOX_SIGMA_REL = 1e-6
BOX_MAX_LOSS = 0.5
BOX_PAD_PX = 1.0
BOX_PAD_REL = 1e-4
WARPS = 16
BLOCK_W = 8
BLOCK_H = 8
FLT_MAX = torch.finfo(torch.float32).max

_VP, _INT = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("raster3d_fwd",
                    [_VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP, _VP])
_BWD_ARGS = [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP]
KERNEL_BWD = CudaKernel("raster3d_bwd", _BWD_ARGS + [_VP])
_FWD_OCCUPANCY = CudaKernel("raster3d_fwd_occupancy", [ctypes.POINTER(_INT)],
                            source="raster3d_fwd")

# T1: K1's arguments, the tile counter, the schedule and the grid size;
# the slots query gives the grid
SCHEDULES = ("static", "dynamic")
_PINT = ctypes.POINTER(_INT)
KERNEL_PERSISTENT = CudaKernel(
    "raster3d_fwd_persistent",
    [_VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP, _VP, _INT, _INT, _VP])
_PERSISTENT_SLOTS = CudaKernel("raster3d_fwd_persistent_slots",
                               [_INT, _PINT],
                               source="raster3d_fwd_persistent")

# T2: K2 with parts removed (see csrc/raster3d_bwd.cu); "full" is K2's own
# build, launched through its own counter. The stripped variants take a
# sentinel (NaN) that keeps their results alive and the shared memory each
# block reserves to stay at K2's blocks per SM.
VARIANTS = ("full", "no_atomic", "no_color", "no_reduce", "walk_only")
KERNELS_BWD_VARIANT = {"full": CudaKernel("raster3d_bwd", _BWD_ARGS + [_VP])}
KERNELS_BWD_VARIANT.update({
    v: CudaKernel("raster3d_bwd_variant",
                  _BWD_ARGS + [ctypes.c_float, _INT, _VP],
                  source="raster3d_bwd", defines=(f"K2_VARIANT={i}",))
    for i, v in enumerate(VARIANTS) if i > 0})
_BWD_OCCUPANCY = {v: CudaKernel("raster3d_bwd_occupancy",
                                [_INT, _PINT, _PINT], source="raster3d_bwd",
                                defines=k.defines)
                  for v, k in KERNELS_BWD_VARIANT.items()}


def local_pixel_coords(device):
    """Pixel centres inside a tile, (P,) x and (P,) y, row-major."""
    p = torch.arange(P, device=device)
    return (p % TILE_W).float() + 0.5, (p // TILE_W).float() + 0.5


def warp_of_pixel(device) -> torch.Tensor:
    """(P,) the warp of K1's and K2's blocks that owns each pixel."""
    p = torch.arange(P, device=device)
    return (p // TILE_W // BLOCK_H) * (TILE_W // BLOCK_W) \
        + (p % TILE_W) // BLOCK_W


def occupancy(device_index: int) -> int:
    """K1's blocks per SM on the card `device_index` (a query of the
    runtime; launches nothing). K2's is `variant_occupancy("full", .)`."""
    blocks = _INT(0)
    with torch.cuda.device(device_index):
        _FWD_OCCUPANCY.call(ctypes.byref(blocks))
    return blocks.value


def _sigma(f: torch.Tensor, t: int, n_tiles_x: int, lx: torch.Tensor,
           ly: torch.Tensor):
    """(dx, dy, sigma), each (P, count), of tile t's pixels (local centres
    lx, ly) against the fields f (count, 10): sigma's products and sums in
    the kernels' order, one rounding each."""
    dx = (lx + float((t % n_tiles_x) * TILE_W))[:, None] - f[None, :, 0]
    dy = (ly + float((t // n_tiles_x) * TILE_H))[:, None] - f[None, :, 1]
    sigma = (0.5 * f[None, :, 2] * dx * dx + f[None, :, 3] * dx * dy
             + 0.5 * f[None, :, 4] * dy * dy)
    return dx, dy, sigma


def skip_threshold(op: torch.Tensor) -> torch.Tensor:
    """thr per gaussian, float32 as the kernels compute it (to within an ulp
    of the log): ln(255 op) widened by REJECT_REL of itself and by
    REJECT_ABS, at least THR_FLOOR; -1 where op <= 0; NaN (nothing skipped)
    where op is not finite."""
    tau = torch.log(255.0 * op)
    thr = torch.clamp_min(tau + REJECT_REL * torch.abs(tau) + REJECT_ABS,
                          THR_FLOOR)
    thr = torch.where(op <= 0, torch.full_like(thr, -1.0), thr)
    return torch.where(torch.isfinite(op), thr, torch.full_like(thr, math.nan))


def segment_reject(f: torch.Tensor, t: int, n_tiles_x: int,
                   lx: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    """(P, count) bool: the pairs of tile t's pixels and the gaussians f
    (count, 10) that the kernels' test skips: the rounded sigma above
    `skip_threshold`. A skipped pair has alpha = 0."""
    return _sigma(f, t, n_tiles_x, lx, ly)[2] > skip_threshold(f[:, 5])


def support_box(f: torch.Tensor) -> torch.Tensor:
    """(count, 4) float32 (x0, x1, y0, y1): pixel centres outside
    [x0, x1] x [y0, y1] have alpha = 0 with the gaussians f (count, 10).
    The kernels' double-precision box of the ellipse sigma <= 1.001 thr /
    (1 - BOX_SIGMA_REL kappa) (kappa the conic's condition number), widened
    (to the last bits of a double); the whole plane where thr is NaN, the
    conic is not positive definite, BOX_SIGMA_REL kappa > BOX_MAX_LOSS or
    anything is not finite; empty where thr < 0."""
    thr = skip_threshold(f[:, 5])
    mx, my, a, b, c = f[:, :5].double().unbind(1)
    det = a * c - b * b
    ok = ((a > 0) & (det > 0) & torch.isfinite(det) & torch.isfinite(mx)
          & torch.isfinite(my) & ~torch.isnan(thr))
    half = 0.5 * (a + c)
    r = torch.sqrt(0.25 * (a - c) * (a - c) + b * b)
    loss = BOX_SIGMA_REL * (half + r) / (det / (half + r))
    ok &= loss <= BOX_MAX_LOSS
    t = BOX_RHO_SCALE * thr.double() / (1.0 - loss)
    hx = torch.sqrt(2.0 * t * c / det)
    hy = torch.sqrt(2.0 * t * a / det)
    px = BOX_PAD_PX + BOX_PAD_REL * (torch.abs(mx) + hx)
    py = BOX_PAD_PX + BOX_PAD_REL * (torch.abs(my) + hy)
    box = torch.stack([mx - hx - px, mx + hx + px, my - hy - py,
                       my + hy + py], 1).float()
    inf = math.inf
    res = torch.tensor([-inf, inf, -inf, inf],
                       device=f.device).expand_as(box)
    empty = torch.tensor([inf, -inf, inf, -inf], device=f.device)
    res = torch.where((ok & (thr < 0))[:, None], empty, res)
    fits = ok & (thr >= 0) & (box.abs() <= FLT_MAX).all(1)
    return torch.where(fits[:, None], box, res)


def warp_cull(f: torch.Tensor, t: int, n_tiles_x: int) -> torch.Tensor:
    """(WARPS, count) bool: warp w of tile t's block skips gaussian j of f
    (count, 10) outright, its pixel centres all outside the support box."""
    box = support_box(f)
    w = torch.arange(WARPS, device=f.device)
    bx = TILE_W // BLOCK_W
    xl = (float((t % n_tiles_x) * TILE_W) + (w % bx * BLOCK_W).float()
          + 0.5)[:, None]
    yl = (float((t // n_tiles_x) * TILE_H) + (w // bx * BLOCK_H).float()
          + 0.5)[:, None]
    xh, yh = xl + (BLOCK_W - 1), yl + (BLOCK_H - 1)
    return ((box[None, :, 1] < xl) | (box[None, :, 0] > xh)
            | (box[None, :, 3] < yl) | (box[None, :, 2] > yh))


def _segment_geometry(f: torch.Tensor, t: int, n_tiles_x: int,
                      lx: torch.Tensor, ly: torch.Tensor):
    """(dx, dy, raw alpha, alpha), each (P, count), of tile t's pixels
    (local centres lx, ly) against the fields f (count, 10) of its segment:
    alpha capped and cut off as K1 does, sigma's products and sums in the
    kernel's order."""
    dx, dy, sigma = _sigma(f, t, n_tiles_x, lx, ly)
    raw = f[None, :, 5] * torch.exp(-sigma)
    alpha = torch.clamp_max(raw, MAX_ALPHA)
    alpha = torch.where(alpha >= ALPHA_CUTOFF, alpha, torch.zeros_like(alpha))
    return dx, dy, raw, alpha


def segment_alpha(f: torch.Tensor, t: int, n_tiles_x: int, lx: torch.Tensor,
                  ly: torch.Tensor) -> torch.Tensor:
    """(P, count) alpha of tile t's pixels against its segment's fields."""
    return _segment_geometry(f, t, n_tiles_x, lx, ly)[3]


def n_contrib_off_the_stop(fields: torch.Tensor, gauss_id: torch.Tensor,
                           tile_starts: torch.Tensor, n_tiles_x: int,
                           nc_a: torch.Tensor, logT_a: torch.Tensor,
                           nc_b: torch.Tensor, logT_b: torch.Tensor) -> int:
    """Pixels whose n_contrib differs between two runs of K1 (counts and
    final log T, each (n_tiles, P)) and that are not at the 1e-4 stop.
    Summed in another order, a pixel's log T may cross log 1e-4 one
    contributing gaussian later, after any number of gaussians with alpha
    below 1/255. So where the counts differ, both final log T must be at
    the stop (within 1e-4) and at most one gaussian between the two counts
    may have alpha >= 1/255 at that pixel; 0 means the runs agree."""
    lx, ly = local_pixel_coords(fields.device)
    bad = 0
    for t, p in (nc_a != nc_b).nonzero().tolist():
        lo, hi = sorted((int(nc_a[t, p]), int(nc_b[t, p])))
        s = int(tile_starts[t])
        alpha = segment_alpha(fields[gauss_id[s + lo:s + hi].long()], t,
                              n_tiles_x, lx, ly)[p]
        at_stop = (max(float(logT_a[t, p]), float(logT_b[t, p]))
                   <= LOG_T_EPS + 1e-4)
        bad += int(not at_stop or int((alpha > 0).sum()) > 1)
    return bad


def rasterize_fwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                        tile_starts: torch.Tensor, n_tiles_x: int,
                        n_tiles_y: int):
    """Plain PyTorch K1, tile by tile: a (P, count) alpha matrix, the
    log-transmittance before each gaussian as an exclusive cumsum of
    log1p(-alpha), and the w mask — the dense oracle's arithmetic
    restricted to the segment, in the kernel's log space and order.
    Differentiable in `fields` under autograd (the tests hold K2 to it)."""
    n_tiles = n_tiles_x * n_tiles_y
    dev = fields.device
    acc = torch.zeros((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    logT = torch.zeros((n_tiles, 2, P), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((n_tiles, P), dtype=torch.int32, device=dev)
    lx, ly = local_pixel_coords(dev)
    starts = tile_starts.tolist()
    for t in range(n_tiles):
        s, e = starts[t], starts[t + 1]
        count = e - s
        if count == 0:
            continue
        f = fields[gauss_id[s:e].long()]                    # (count, 10)
        alpha = segment_alpha(f, t, n_tiles_x, lx, ly)       # (P, count)
        lam = torch.log1p(-alpha)
        incl = torch.cumsum(lam, dim=1)
        excl = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
        live = excl > LOG_T_EPS                              # a prefix per pixel
        w = torch.where(live, alpha * torch.exp(excl), torch.zeros_like(alpha))
        acc[t, 0:3] = (w @ f[:, 6:9]).T
        acc[t, 3] = w @ f[:, 9]
        acc[t, 4] = w.sum(dim=1)
        # a pixel stops after its last live gaussian; the tile's walk after
        # the chunk in which its last pixel stopped
        n_live = live.sum(dim=1)                             # >= 1
        final = incl.gather(1, (n_live - 1)[:, None])[:, 0]
        logT[t, 0] = final
        n_contrib[t] = n_live.int()
        n_chunks = -(-count // G)
        if bool((final > LOG_T_EPS).any()):
            i_fin = n_chunks
        else:
            i_fin = int(((n_live - 1) // G).max()) + 1
        logT[t, 1] = float(i_fin)
    return acc, logT, n_contrib


def _check(name, x, dtype, ndim, device):
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                         f"{x.dim()}-D {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, fields on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_segments(fields, gauss_id, tile_starts, n_tiles,
                    n_fields=N_FIELDS):
    dev = fields.device
    _check("fields", fields, torch.float32, 2, dev)
    _check("gauss_id", gauss_id, torch.int32, 1, dev)
    _check("tile_starts", tile_starts, torch.int32, 1, dev)
    if fields.shape[1] != n_fields:
        raise ValueError(f"fields must be (N, {n_fields}), got "
                         f"{tuple(fields.shape)}")
    if tile_starts.shape[0] != n_tiles + 1:
        raise ValueError(f"tile_starts must have n_tiles+1 = {n_tiles + 1} "
                         f"entries, got {tile_starts.shape[0]}")
    if max(fields.shape[0], gauss_id.shape[0]) >= 2 ** 31:
        raise ValueError("more than 2^31 gaussians or instances")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the rasterizer kernels run on cuda or cpu, "
                         f"not {dev}")


def _check_aligned(fields):
    if fields.data_ptr() % 8:
        raise ValueError("the kernels copy fields in 8-byte pieces: its "
                         "storage must be 8-byte aligned")


def _check_shape(name, x, shape):
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def rasterize_fwd(fields: torch.Tensor, gauss_id: torch.Tensor,
                  tile_starts: torch.Tensor, n_tiles_x: int, n_tiles_y: int):
    """K1 (see the module docstring): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Returns (acc, logT, n_contrib).
    `gauss_id` values and the monotonicity of `tile_starts` are the
    binning's guarantee and are not checked on the device."""
    dev = fields.device
    n_tiles = n_tiles_x * n_tiles_y
    _check_segments(fields, gauss_id, tile_starts, n_tiles)
    if dev.type == "cpu":
        return rasterize_fwd_plain(fields, gauss_id, tile_starts, n_tiles_x,
                                   n_tiles_y)
    _check_aligned(fields)
    acc = torch.empty((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    logT = torch.empty((n_tiles, 2, P), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((n_tiles, P), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return acc, logT, n_contrib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(fields.data_ptr(), gauss_id.data_ptr(),
                      tile_starts.data_ptr(), n_tiles, n_tiles_x,
                      acc.data_ptr(), logT.data_ptr(), n_contrib.data_ptr(),
                      stream)
    return acc, logT, n_contrib


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, not "
                         f"{schedule!r}")


@functools.lru_cache(maxsize=None)
def _persistent_slots(schedule: str, device_index: int) -> int:
    slots = _INT(0)
    with torch.cuda.device(device_index):
        _PERSISTENT_SLOTS.call(SCHEDULES.index(schedule), ctypes.byref(slots))
    return slots.value


def persistent_grid(n_tiles: int, schedule: str, device) -> int:
    """T1's grid on the card `device` for n_tiles tiles: one block per
    resident slot (blocks per SM at full occupancy x SMs), at most one per
    tile."""
    _check_schedule(schedule)
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return min(n_tiles, max(1, _persistent_slots(schedule, index)))


def rasterize_fwd_persistent(fields: torch.Tensor, gauss_id: torch.Tensor,
                             tile_starts: torch.Tensor, n_tiles_x: int,
                             n_tiles_y: int, schedule: str = "dynamic"):
    """T1: K1's function and outputs (acc, logT, n_contrib), bit for bit
    K1's on the card, from `persistent_grid` persistent blocks that walk
    tiles in `schedule` ("static": strided; "dynamic": taken from a global
    counter). For CPU tensors, K1's plain version."""
    _check_schedule(schedule)
    dev = fields.device
    n_tiles = n_tiles_x * n_tiles_y
    _check_segments(fields, gauss_id, tile_starts, n_tiles)
    if dev.type == "cpu":
        return rasterize_fwd_plain(fields, gauss_id, tile_starts, n_tiles_x,
                                   n_tiles_y)
    _check_aligned(fields)
    acc = torch.empty((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    logT = torch.empty((n_tiles, 2, P), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((n_tiles, P), dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return acc, logT, n_contrib
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    grid = persistent_grid(n_tiles, schedule, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL_PERSISTENT.launch(
            fields.data_ptr(), gauss_id.data_ptr(), tile_starts.data_ptr(),
            n_tiles, n_tiles_x, acc.data_ptr(), logT.data_ptr(),
            n_contrib.data_ptr(), counter.data_ptr(),
            SCHEDULES.index(schedule), grid, stream)
    return acc, logT, n_contrib


def rasterize_bwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                        tile_starts: torch.Tensor, d_acc: torch.Tensor,
                        d_logT: torch.Tensor, logT: torch.Tensor,
                        n_contrib: torch.Tensor, n_tiles_x: int,
                        n_tiles_y: int) -> torch.Tensor:
    """Plain PyTorch K2, tile by tile, in closed form (no autograd): each
    pixel's log T before every gaussian it walked is rebuilt from its final
    log T by a suffix sum of log1p(-alpha) over [j, n_contrib), S_after by
    a strict suffix sum of w·dL/dw, and the per-instance gradients are
    column sums over the tile's pixels, added to the gaussians' rows."""
    grad = torch.zeros_like(fields)
    lx, ly = local_pixel_coords(fields.device)
    starts = tile_starts.tolist()
    for t in range(n_tiles_x * n_tiles_y):
        s, e = starts[t], starts[t + 1]
        count = e - s
        if count == 0:
            continue
        ids = gauss_id[s:e].long()
        f = fields[ids]                                      # (count, 10)
        dx, dy, raw, alpha = _segment_geometry(f, t, n_tiles_x, lx, ly)
        walked = (torch.arange(count, device=fields.device)[None, :]
                  < n_contrib[t][:, None])                   # (P, count)
        alpha = torch.where(walked, alpha, torch.zeros_like(alpha))
        lam = torch.log1p(-alpha)
        # log T before gaussian j = final log T - sum of lam over [j, n)
        suffix = torch.flip(torch.cumsum(torch.flip(lam, [1]), 1), [1])
        w = alpha * torch.exp(logT[t][:, None] - suffix)
        g = d_acc[t]                                         # (5, P)
        dw = g[0:4].T @ f[:, 6:10].T + g[4][:, None]         # (P, count)
        wdw = w * dw
        after = torch.flip(torch.cumsum(torch.flip(wdw, [1]), 1), [1]) - wdw
        S_after = d_logT[t][:, None] + after
        live = (alpha > 0) & (raw < MAX_ALPHA)
        dsig = torch.where(live, S_after * (alpha / (1.0 - alpha)) - wdw,
                           torch.zeros_like(wdw))
        u, v = dsig * dx, dsig * dy
        s0, sx, sy = dsig.sum(0), u.sum(0), v.sum(0)
        sxx, sxy, syy = (u * dx).sum(0), (u * dy).sum(0), (v * dy).sum(0)
        a, b, c, op = f[:, 2], f[:, 3], f[:, 4], f[:, 5]
        gop = torch.where(op > 0, -s0 / torch.clamp_min(op, 1e-12),
                          torch.zeros_like(s0))
        gcd = (g[0:4] @ w).T                                 # (count, 4)
        per_inst = torch.cat([
            torch.stack([-(a * sx + b * sy), -(b * sx + c * sy), 0.5 * sxx,
                         sxy, 0.5 * syy, gop], dim=1), gcd], dim=1)
        grad.index_add_(0, ids, per_inst)
    return grad


def rasterize_bwd(fields: torch.Tensor, gauss_id: torch.Tensor,
                  tile_starts: torch.Tensor, d_acc: torch.Tensor,
                  d_logT: torch.Tensor, logT: torch.Tensor,
                  n_contrib: torch.Tensor, n_tiles_x: int,
                  n_tiles_y: int) -> torch.Tensor:
    """K2 (see the module docstring): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Returns grad_fields (N, 10)."""
    _check_bwd(fields, gauss_id, tile_starts, d_acc, d_logT, logT, n_contrib,
               n_tiles_x * n_tiles_y)
    if fields.device.type == "cpu":
        return rasterize_bwd_plain(fields, gauss_id, tile_starts, d_acc,
                                   d_logT, logT, n_contrib, n_tiles_x,
                                   n_tiles_y)
    return _launch_bwd(KERNEL_BWD, (), fields, gauss_id, tile_starts, d_acc,
                       d_logT, logT, n_contrib, n_tiles_x, n_tiles_y)


def _check_bwd(fields, gauss_id, tile_starts, d_acc, d_logT, logT,
               n_contrib, n_tiles):
    dev = fields.device
    _check_segments(fields, gauss_id, tile_starts, n_tiles)
    for name, x, dtype, shape in (
            ("d_acc", d_acc, torch.float32, (n_tiles, N_ACC, P)),
            ("d_logT", d_logT, torch.float32, (n_tiles, P)),
            ("logT", logT, torch.float32, (n_tiles, P)),
            ("n_contrib", n_contrib, torch.int32, (n_tiles, P))):
        _check(name, x, dtype, len(shape), dev)
        _check_shape(name, x, shape)


def _launch_bwd(kernel, extra, fields, gauss_id, tile_starts, d_acc, d_logT,
                logT, n_contrib, n_tiles_x, n_tiles_y):
    """K2's launch (or a T2 variant's, with `extra` arguments before the
    stream) into a zeroed (N, 10) gradient."""
    dev = fields.device
    n_tiles = n_tiles_x * n_tiles_y
    _check_aligned(fields)
    grad = torch.zeros_like(fields)
    if n_tiles == 0:
        return grad
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel.launch(fields.data_ptr(), gauss_id.data_ptr(),
                      tile_starts.data_ptr(), d_acc.data_ptr(),
                      d_logT.data_ptr(), logT.data_ptr(),
                      n_contrib.data_ptr(), n_tiles, n_tiles_x,
                      grad.data_ptr(), *extra, stream)
    return grad


def rasterize_bwd_variant(variant: str, fields: torch.Tensor,
                          gauss_id: torch.Tensor, tile_starts: torch.Tensor,
                          d_acc: torch.Tensor, d_logT: torch.Tensor,
                          logT: torch.Tensor, n_contrib: torch.Tensor,
                          n_tiles_x: int, n_tiles_y: int) -> torch.Tensor:
    """T2: the K2 variant `variant` (one of `VARIANTS`) on K2's arguments.
    "full" is K2 (its plain version for CPU tensors) and returns its
    gradient; of the stripped variants, no_color returns the six geometric
    gradients of dL/dw without its colour and depth terms and the others
    zeros (they store nothing). Computing no function a caller uses, the
    stripped variants raise for CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not "
                         f"{variant!r}")
    args = (fields, gauss_id, tile_starts, d_acc, d_logT, logT, n_contrib)
    _check_bwd(*args, n_tiles_x * n_tiles_y)
    if fields.device.type == "cpu":
        if variant == "full":
            return rasterize_bwd_plain(*args, n_tiles_x, n_tiles_y)
        raise ValueError(f"the K2 variant {variant!r} is a measurement of "
                         "the card and has no CPU version")
    extra = ()
    if variant != "full":
        pad, _ = variant_occupancy(variant, fields.device.index)
        extra = (ctypes.c_float(math.nan), pad)
    return _launch_bwd(KERNELS_BWD_VARIANT[variant], extra, *args,
                       n_tiles_x, n_tiles_y)


@functools.lru_cache(maxsize=None)
def variant_occupancy(variant: str, device_index: int) -> tuple:
    """(pad, blocks per SM) of the K2 variant `variant` on the card
    `device_index`: the bytes of dynamic shared memory each of its blocks
    reserves, unused, so that no more of them are resident per SM than of
    K2's, and the blocks per SM it then has. "full" is K2: pad 0 and K2's
    own blocks per SM."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not "
                         f"{variant!r}")

    def query(v, target):
        pad, blocks = _INT(0), _INT(0)
        with torch.cuda.device(device_index):
            _BWD_OCCUPANCY[v].call(target, ctypes.byref(pad),
                                   ctypes.byref(blocks))
        return pad.value, blocks.value

    k2 = query("full", 0)
    return k2 if variant == "full" else query(variant, k2[1])
