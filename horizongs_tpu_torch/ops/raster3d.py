"""K1: 3DGS front-to-back compositing of each tile's depth-sorted instance
segment, forward only.

`rasterize_fwd` launches the CUDA kernel `csrc/raster3d_fwd.cu` for CUDA
tensors and runs `rasterize_fwd_plain`, the same function in plain
PyTorch, for CPU tensors. The kernel replaces the Pallas TPU kernel
`horizongs_tpu/ops/pallas/raster3d.py::_fwd_kernel`; its source says what
bounds it on Hopper (the exp per pixel-gaussian pair on the special-
function units) and how its design meets that.

Contract (the TPU kernel's, minus the instance copy it needed):
  fields      (N, 10) float32: mx, my, conic a, b, c, opacity, r, g, b, depth
  gauss_id    (CAP,) int32 gaussian of each sorted instance
  tile_starts (n_tiles+1,) int32: tile t's segment is
              [tile_starts[t], tile_starts[t+1]), depth-sorted
  -> acc  (n_tiles, 5, P) float32: rows r, g, b, depth, alpha (the TPU
          kernel's acc rows 6-10)
     logT (n_tiles, 2, P) float32: row 0 the final log transmittance, row 1
          i_fin, the number of G-gaussian chunks the tile's walk reached
          before all its pixels stopped (0 for an empty tile)
Tiles are 32x32 (P = 1024 pixels, row-major), tile t at column
t % n_tiles_x, row t // n_tiles_x.
"""
from __future__ import annotations

import ctypes
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

_VP, _INT = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("raster3d_fwd",
                    [_VP, _VP, _VP, _INT, _INT, _VP, _VP, _VP])


def local_pixel_coords(device):
    """Pixel centres inside a tile, (P,) x and (P,) y, row-major."""
    p = torch.arange(P, device=device)
    return (p % TILE_W).float() + 0.5, (p // TILE_W).float() + 0.5


def segment_alpha(f: torch.Tensor, t: int, n_tiles_x: int, lx: torch.Tensor,
                  ly: torch.Tensor) -> torch.Tensor:
    """(P, count) alpha of tile t's pixels (local centres lx, ly) against
    the fields f (count, 10) of its segment, capped and cut off as K1 does,
    with sigma's products and sums in the kernel's order."""
    dx = (lx + float((t % n_tiles_x) * TILE_W))[:, None] - f[None, :, 0]
    dy = (ly + float((t // n_tiles_x) * TILE_H))[:, None] - f[None, :, 1]
    sigma = (0.5 * f[None, :, 2] * dx * dx + f[None, :, 3] * dx * dy
             + 0.5 * f[None, :, 4] * dy * dy)
    alpha = torch.clamp_max(f[None, :, 5] * torch.exp(-sigma), MAX_ALPHA)
    return torch.where(alpha >= ALPHA_CUTOFF, alpha, torch.zeros_like(alpha))


def rasterize_fwd_plain(fields: torch.Tensor, gauss_id: torch.Tensor,
                        tile_starts: torch.Tensor, n_tiles_x: int,
                        n_tiles_y: int):
    """Plain PyTorch K1, tile by tile: a (P, count) alpha matrix, the
    log-transmittance before each gaussian as an exclusive cumsum of
    log1p(-alpha), and the w mask — the dense oracle's arithmetic
    restricted to the segment, in the kernel's log space and order."""
    n_tiles = n_tiles_x * n_tiles_y
    dev = fields.device
    acc = torch.zeros((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    logT = torch.zeros((n_tiles, 2, P), dtype=torch.float32, device=dev)
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
        n_chunks = -(-count // G)
        if bool((final > LOG_T_EPS).any()):
            i_fin = n_chunks
        else:
            i_fin = int(((n_live - 1) // G).max()) + 1
        logT[t, 1] = float(i_fin)
    return acc, logT


def _check(name, x, dtype, ndim, device):
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                         f"{x.dim()}-D {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, fields on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rasterize_fwd(fields: torch.Tensor, gauss_id: torch.Tensor,
                  tile_starts: torch.Tensor, n_tiles_x: int, n_tiles_y: int):
    """K1 (see the module docstring): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. `gauss_id` values and the
    monotonicity of `tile_starts` are the binning's guarantee and are not
    checked on the device."""
    dev = fields.device
    n_tiles = n_tiles_x * n_tiles_y
    _check("fields", fields, torch.float32, 2, dev)
    _check("gauss_id", gauss_id, torch.int32, 1, dev)
    _check("tile_starts", tile_starts, torch.int32, 1, dev)
    if fields.shape[1] != N_FIELDS:
        raise ValueError(f"fields must be (N, {N_FIELDS}), got "
                         f"{tuple(fields.shape)}")
    if tile_starts.shape[0] != n_tiles + 1:
        raise ValueError(f"tile_starts must have n_tiles+1 = {n_tiles + 1} "
                         f"entries, got {tile_starts.shape[0]}")
    if max(fields.shape[0], gauss_id.shape[0]) >= 2 ** 31:
        raise ValueError("more than 2^31 gaussians or instances")
    if dev.type == "cpu":
        return rasterize_fwd_plain(fields, gauss_id, tile_starts, n_tiles_x,
                                   n_tiles_y)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_fwd runs on cuda or cpu, not {dev}")
    acc = torch.empty((n_tiles, N_ACC, P), dtype=torch.float32, device=dev)
    logT = torch.empty((n_tiles, 2, P), dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return acc, logT
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(fields.data_ptr(), gauss_id.data_ptr(),
                      tile_starts.data_ptr(), n_tiles, n_tiles_x,
                      acc.data_ptr(), logT.data_ptr(), stream)
    return acc, logT
