"""Tile-band record exchange: route projected splats to their band's rank.

The JAX package's `parallel/tile_exchange.py`. The image's tile rows are
split into `n_model` contiguous bands; model index m owns tile rows
[bounds[m], bounds[m+1]). Each rank projects only its own anchor rows'
gaussians and sends each splat record to the band(s) its screen footprint
touches — an all_to_all of compact (11 or 20 float) records
(`parallel/collectives.all_to_all`) — then bins and composites only its
band. No rank ever holds the whole decoded set.

Each (source, destination) pair carries `send_cap` record slots, compacted
per destination with one row-wise sort. Overflow is dropped and counted,
never silent: the trainer recalibrates the capacity as it does for the
tile-instance list.

The exchange is a differentiable gather and all_to_all: a record's
gradient comes back to the rank that owns its anchor on the reverse
all_to_all, and a record sent to two bands receives the sum of both
bands' gradients through the gather's transpose.

`exchange_halo` (the JAX package's ppermute of band rows) is not ported:
the step routes records to every band whose halo-extended rows they touch
and composites the halo itself, so nothing calls it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from horizongs_tpu_torch.parallel.collectives import all_to_all


class BandLayout(NamedTuple):
    n_model: int
    tile_h: int
    band_rows: int    # tile rows of the tallest band (the static height)
    n_tiles_y: int    # real tile rows in the full image
    height: int       # full image height (pixels)
    width: int
    # band boundaries in tile rows, n_model + 1 of them, bounds[0] = 0,
    # bounds[-1] >= n_tiles_y; uniform by default, `suggest_band_bounds`
    # gives load-balanced ones
    bounds: tuple = ()

    @property
    def band_px(self) -> int:
        """Pixel height of the tallest band: the composite height every
        rank uses (shorter bands mask their tail)."""
        return self.band_rows * self.tile_h

    @property
    def starts_px(self) -> tuple:
        return tuple(b * self.tile_h for b in self.bounds[:-1])

    @property
    def heights_px(self) -> tuple:
        return tuple((b1 - b0) * self.tile_h
                     for b0, b1 in zip(self.bounds[:-1], self.bounds[1:]))


def band_layout(height: int, width: int, n_model: int, tile_h: int,
                bounds=None) -> BandLayout:
    n_tiles_y = -(-height // tile_h)
    if bounds is None:
        # uniform: every band spans the same tile-row count (trailing bands
        # may lie past the image bottom)
        rows = -(-n_tiles_y // n_model)
        bounds = tuple(m * rows for m in range(n_model + 1))
    bounds = tuple(int(b) for b in bounds)
    if len(bounds) != n_model + 1 or bounds[0] != 0:
        raise ValueError(f"bounds must be n_model+1 tile-row offsets "
                         f"starting at 0, got {bounds}")
    if any(b1 <= b0 for b0, b1 in zip(bounds[:-1], bounds[1:])):
        raise ValueError(f"bounds must be strictly increasing: {bounds}")
    if bounds[-1] < n_tiles_y:
        raise ValueError(f"bounds {bounds} do not cover the image's "
                         f"{n_tiles_y} tile rows")
    band_rows = max(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:]))
    return BandLayout(n_model=n_model, tile_h=tile_h, band_rows=band_rows,
                      n_tiles_y=n_tiles_y, height=height, width=width,
                      bounds=bounds)


def band_span(means2d_y: torch.Tensor, ry: torch.Tensor,
              layout: BandLayout, halo_px: int = 0):
    """Inclusive band index range [b0, b1] each splat's vertical extent
    touches, each band's rows extended by `halo_px` on both sides (a splat
    goes to every band whose extended rows it touches, so each rank can
    composite its band plus halo rows itself). band_of(q) counts the
    interior boundaries at or above q."""
    starts = [b * layout.tile_h for b in layout.bounds[1:-1]]
    lo = means2d_y - ry - halo_px
    hi = means2d_y + ry + halo_px
    if not starts:
        z = torch.zeros(means2d_y.shape, dtype=torch.int32,
                        device=means2d_y.device)
        return z, z
    sb = torch.tensor(starts, dtype=means2d_y.dtype, device=means2d_y.device)
    b0 = torch.sum(lo[:, None] >= sb[None, :], dim=1).int()
    b1 = torch.sum(hi[:, None] >= sb[None, :], dim=1).int()
    return b0, b1


def _route_mask(means2d_y, ry, valid, layout, halo_px):
    """(n_model, K) bool: record k goes to band m."""
    b0, b1 = band_span(means2d_y, ry, layout, halo_px)
    dests = torch.arange(layout.n_model, dtype=torch.int32,
                         device=means2d_y.device)[:, None]
    return valid[None, :] & (b0[None, :] <= dests) & (dests <= b1[None, :])


def route_records(records: torch.Tensor, means2d_y: torch.Tensor,
                  ry: torch.Tensor, valid: torch.Tensor,
                  layout: BandLayout, send_cap: int, halo_px: int = 0):
    """Compact records into per-destination send blocks, each in the
    records' order. records: (K, R) rows to route (a zeroed row must
    invalidate itself: its binning radius column is 0). Returns (send
    (n_model * send_cap, R), n_dropped ()); per-rank code, usable outside
    a mesh."""
    K = records.shape[0]
    dev = records.device
    mask = _route_mask(means2d_y, ry, valid, layout, halo_px)
    rows = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    keys = torch.where(mask, rows, torch.full_like(rows, K))
    keys = torch.sort(keys, dim=1).values[:, :send_cap]     # (n_model, S)
    if keys.shape[1] < send_cap:                             # cap above K
        keys = torch.cat([keys, torch.full(
            (layout.n_model, send_cap - keys.shape[1]), K,
            dtype=keys.dtype, device=dev)], dim=1)
    slot_valid = keys < K
    # an empty slot reads a row of its own, zeroed below: were they all to
    # read one row, the gather's backward (an accumulating index_put,
    # which walks each row's duplicates in turn on the card) would add
    # every empty slot's zero to that row one after another
    spread = torch.arange(keys.numel(), device=dev).reshape(keys.shape) % K
    idx = torch.where(slot_valid, keys, spread).reshape(-1)
    send = records[idx] * slot_valid.reshape(-1, 1).to(records.dtype)
    n_dropped = (mask.sum() - slot_valid.sum()).int()
    return send, n_dropped


def exchange_records(records: torch.Tensor, means2d_y: torch.Tensor,
                     ry: torch.Tensor, valid: torch.Tensor,
                     layout: BandLayout, send_cap: int, group=None,
                     halo_px: int = 0):
    """Route, then all_to_all over the "model" group. Returns (recv
    (n_model * send_cap, R), n_dropped ()): the records every rank routed
    to this rank's band (and its halo rows)."""
    if layout.n_model == 1 and send_cap >= records.shape[0]:
        # one band: every record is this rank's; skip the routing sort
        # and its gather (whose transpose is a scatter in the backward)
        keep = valid.to(records.dtype)[:, None]
        return records * keep, torch.zeros((), dtype=torch.int32,
                                           device=records.device)
    send, n_dropped = route_records(records, means2d_y, ry, valid, layout,
                                    send_cap, halo_px)
    if layout.n_model == 1:
        return send, n_dropped
    return all_to_all(send, group), n_dropped


@torch.no_grad()
def count_routed_records(means2d_y: torch.Tensor, ry: torch.Tensor,
                         valid: torch.Tensor, layout: BandLayout,
                         halo_px: int = 0) -> torch.Tensor:
    """The most records any one band receives from this rank: what
    `send_cap` must cover."""
    return _route_mask(means2d_y, ry, valid, layout, halo_px).sum(1).max()


@torch.no_grad()
def count_tile_row_loads(means2d_y: torch.Tensor, ry: torch.Tensor,
                         valid: torch.Tensor, n_tiles_y: int,
                         tile_h: int) -> torch.Tensor:
    """Records whose vertical extent touches each tile row: the load
    profile `suggest_band_bounds` balances."""
    ty0 = torch.clamp(torch.floor((means2d_y - ry) / tile_h), 0,
                      n_tiles_y - 1).int()
    ty1 = torch.clamp(torch.floor((means2d_y + ry) / tile_h), 0,
                      n_tiles_y - 1).int()
    rows = torch.arange(n_tiles_y, dtype=torch.int32,
                        device=means2d_y.device)[:, None]
    touch = (valid[None, :] & (ty0[None, :] <= rows)
             & (rows <= ty1[None, :]))
    return touch.sum(1)


def suggest_band_bounds(row_loads, n_model: int) -> tuple:
    """Load-balanced band boundaries (tile rows, n_model + 1 of them) from
    a per-tile-row load profile: the cumulative load cut at the nearest
    boundary to each equal quantile, each band keeping at least one tile
    row (rows past the bottom when the image has fewer than n_model)."""
    loads = np.asarray(row_loads, np.float64)
    n_rows = len(loads)
    cdf = np.concatenate([[0.0], np.cumsum(loads)])
    total = max(cdf[-1], 1.0)
    bounds = [0]
    for m in range(1, n_model):
        target = total * m / n_model
        i = min(int(np.searchsorted(cdf, target, side="left")), n_rows)
        if i > 0 and target - cdf[i - 1] <= cdf[i] - target:
            i -= 1
        b = max(i, bounds[-1] + 1)
        if b > n_rows - (n_model - m) and n_rows - (n_model - m) > bounds[-1]:
            b = n_rows - (n_model - m)
        bounds.append(b)
    bounds.append(max(n_rows, bounds[-1] + 1))
    return tuple(bounds)


def suggest_band_cap(n_records: int, margin: float = 1.25,
                     align: int = 8) -> int:
    """A measured per-(source rank, band) record count times `margin`,
    rounded up to a geometric bucket (4 per octave, `align`-aligned)."""
    need = max(int(math.ceil(max(n_records, 1) * margin)), align)
    k = max(int(math.ceil(4 * math.log2(need / align))), 0)
    cap = int(math.ceil(align * 2 ** (k / 4)))
    return -(-cap // align) * align
