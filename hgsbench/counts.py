"""The work a call needs, counted from its inputs alone, and the card's
ceilings: the yardstick of the kernels' roofline shares and of `mfu`.

A compositor call's work is every pixel-gaussian pair each pixel walks up
to its own stop (its transmittance at or below 1e-4 after the pair), as
the plain copy in `reference/` computes it, whatever the kernel skips;
of those, the pairs with alpha >= 1/255 contribute. Operations per pair
are the per-pair constants that the program's kernels were designed to
(chip_smoke.py, commit 9bef012: FP32 operations and special-function
results per walked and per contributing pair). Bytes are each input read
once (the field rows the instance list names, the list, the tile starts,
the cotangents) and each output written once.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hgsbench.reference import raster2d, raster3d
from hgsbench.reference.dense import ALPHA_CUTOFF

# published peaks of one H100 SXM (NVIDIA's data sheet)
FP32_FLOPS = 67e12            # outside the tensor cores; the port turns TF32 off
HBM_BYTES_PER_S = 3.35e12
SFU_OPS_PER_SM_CLK = 16       # special-function results per SM per clock

# (FP32 per walked pair, FP32 per contributing pair,
#  SFU per walked pair, SFU per contributing pair)
OPS = {"k1": (15, 14, 1, 2), "k2": (16, 40, 1, 3),
       "k3": (50, 30, 2, 2), "k4": (50, 140, 2, 4)}


class Pairs(NamedTuple):
    walked: int
    contributing: int
    rows: int          # distinct field rows the instance list names
    instances: int
    tiles: int


@torch.no_grad()
def count_pairs(kind: str, fields: torch.Tensor, gauss_id: torch.Tensor,
                tile_starts: torch.Tensor, n_tiles_x: int) -> Pairs:
    """Walked and contributing pairs of a 3DGS (`kind` "3d", 32x32 tiles)
    or 2DGS ("2d", 32x16 tiles) compositor call, tile by tile."""
    mod = raster3d if kind == "3d" else raster2d
    lx, ly = mod.local_pixel_coords(fields.device)
    starts = tile_starts.tolist()
    walked = torch.zeros((), dtype=torch.int64, device=fields.device)
    contrib = torch.zeros_like(walked)
    for t in range(len(starts) - 1):
        s, e = starts[t], starts[t + 1]
        if e == s:
            continue
        f = fields[gauss_id[s:e].long()]
        if kind == "3d":
            alpha = raster3d.segment_alpha(f, t, n_tiles_x, lx, ly)
        else:
            alpha = raster2d.segment_geometry(f, t, n_tiles_x, lx, ly)["alpha"]
        excl = torch.cumsum(torch.log1p(-alpha), dim=1) - torch.log1p(-alpha)
        live = excl > raster3d.LOG_T_EPS
        walked += live.sum()
        contrib += (live & (alpha >= ALPHA_CUTOFF)).sum()
    rows = int(torch.unique(gauss_id[:starts[-1]]).numel())
    return Pairs(int(walked), int(contrib), rows, int(starts[-1]),
                 len(starts) - 1)


def call_bytes(kernel: str, p: Pairs) -> int:
    """Bytes a call reads and writes once: field rows (10 floats for
    3DGS, 18 for 2DGS), the instance list, the tile starts, and per tile
    pixel the rows of its outputs and, backward, of its cotangents and
    records (float32 or int32 each)."""
    pixels = p.tiles * (raster3d.P if kernel in ("k1", "k2") else raster2d.P)
    field = 10 if kernel in ("k1", "k2") else 18
    list_bytes = 4 * (p.instances + p.tiles + 1)
    per_pixel = {"k1": 5 + 2 + 1,              # acc, logT (2 rows), n_contrib
                 "k2": 5 + 1 + 1 + 1,          # d_acc, d_logT, logT, n_contrib
                 "k3": 7 + 4 + 2,              # acc, aux, rec
                 "k4": 7 + 4 + 7 + 4 + 2}[kernel]   # d_acc, d_aux, acc, aux, rec
    rows = p.rows * field * 4 * (2 if kernel in ("k2", "k4") else 1)
    return rows + list_bytes + 4 * per_pixel * pixels


def call_ops(kernel: str, p: Pairs):
    """(FP32 operations, special-function results) of a call."""
    fw, fc, sw, sc = OPS[kernel]
    return (fw * p.walked + fc * p.contributing,
            sw * p.walked + sc * p.contributing)


def least_seconds(kernel: str, p: Pairs, sfu_rate: float) -> float:
    """The least time the card could take for the call: the largest of
    bytes over HBM bandwidth, FP32 operations over the FP32 peak and
    special-function results over the SFU rate."""
    fp32, sfu = call_ops(kernel, p)
    return max(call_bytes(kernel, p) / HBM_BYTES_PER_S, fp32 / FP32_FLOPS,
               sfu / sfu_rate)


def sfu_rate(n_sm: int, sm_clock_hz: float) -> float:
    return SFU_OPS_PER_SM_CLK * n_sm * sm_clock_hz


def mlp_flops_per_anchor(model: dict) -> int:
    """Forward FLOPs of the three decoders for one anchor: two matmuls
    each, d_in -> F -> out, two operations a multiply-add; opacity and cov
    take F + view, colour F + view + appearance."""
    F, k, view = model["feat_dim"], model["n_offsets"], model["view_dim"]
    app = model.get("appearance_dim", 0)
    color = 3 * k if model.get("color_attr", "RGB") == "RGB" else None
    if color is None:
        deg = int("".join(c for c in model["color_attr"] if c.isdigit()))
        color = 3 * (deg + 1) ** 2 * k
    heads = ((F + view, k), (F + view, 7 * k), (F + view + app, color))
    return sum(2 * (d_in * F + F * o) for d_in, o in heads)


# FP32 operations of `reference/sh.eval_sh`'s basis, by degree: degree 1
# scales y, z, x by C1 (3); degree 2 adds xx, yy, zz, xy, yz, xz (6) and
# its five values C2[0] xy (1), C2[1] yz (1), C2[2] (2 zz - xx - yy) (4),
# C2[3] xz (1), C2[4] (xx - yy) (2); degree 3 adds C3[0] y (3 xx - yy)
# (4), C3[1] xy z (2), C3[2] y (4 zz - xx - yy) (5), C3[3] z (2 zz - 3 xx
# - 3 yy) (7), C3[4] x (4 zz - xx - yy) (5), C3[5] z (xx - yy) (3), C3[6]
# x (xx - 3 yy) (4). Degree 0's basis is the constant C0.
SH_BASIS_OPS = (0, 3, 18, 48)


def sh_flops_per_row(model: dict, degree=None) -> int:
    """FP32 operations of the SH evaluation of one decoded row at
    `degree` (None: the configuration's maximum, what a render with no
    active degree evaluates): the basis (`SH_BASIS_OPS`) plus one
    multiply-add, two operations, per coefficient and channel, 3(d+1)^2.
    0 for RGB colours."""
    attr = model.get("color_attr", "RGB")
    if attr == "RGB":
        return 0
    if degree is None:
        degree = int("".join(c for c in attr if c.isdigit()))
    return SH_BASIS_OPS[degree] + 2 * 3 * (degree + 1) ** 2


def step_flops(model: dict, visible_anchors: int, kernels: dict,
               train: bool, sh_degree=None) -> float:
    """The FP32 operations a step needs: the decoders and the SH
    evaluation of their rows (`n_offsets` a visible anchor, at
    `sh_degree`, as `sh_flops_per_row`) over the anchors the view's LOD
    mask and prefilter select (forward, and twice that again backward when
    training) plus the compositors' counted FP32 work (`kernels`: kernel
    -> Pairs)."""
    per_anchor = (mlp_flops_per_anchor(model)
                  + model["n_offsets"] * sh_flops_per_row(model, sh_degree))
    mlp = per_anchor * visible_anchors * (3 if train else 1)
    return mlp + sum(call_ops(k, p)[0] for k, p in kernels.items())


def percent(num: float, den: float):
    """100 num / den, or None where there is nothing to divide by."""
    if not den or not math.isfinite(den):
        return None
    return 100.0 * num / den
