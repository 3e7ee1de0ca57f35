# Frozen copy of horizongs_tpu_torch/ops/raster.py at commit 9bef012, for the
# benchmark's plain reference: imports point at the other copies in
# this folder; the program is never imported.
"""Tile-grid helpers shared by the rasterizers: the padded grid of
`tile_w` x `tile_h` tiles over an image, and the per-tile pixel layout
(row-major inside a tile) back to an (H, W, C) image."""
from __future__ import annotations

from typing import NamedTuple

import torch


class _TileGrid(NamedTuple):
    n_tiles_x: int
    n_tiles_y: int
    tile_w: int
    tile_h: int

    @property
    def n_tiles(self) -> int:
        return self.n_tiles_x * self.n_tiles_y


def _make_grid(width: int, height: int, tile_w: int, tile_h: int) -> _TileGrid:
    return _TileGrid(n_tiles_x=-(-width // tile_w),
                     n_tiles_y=-(-height // tile_h),
                     tile_w=tile_w, tile_h=tile_h)


def _tiles_to_image(tiles: torch.Tensor, grid: _TileGrid,
                    height: int, width: int) -> torch.Tensor:
    """(n_tiles, P, C) -> (H, W, C), cropping the edge tiles' padding."""
    C = tiles.shape[-1]
    img = tiles.reshape(grid.n_tiles_y, grid.n_tiles_x,
                        grid.tile_h, grid.tile_w, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(
        grid.n_tiles_y * grid.tile_h, grid.n_tiles_x * grid.tile_w, C)
    return img[:height, :width]
