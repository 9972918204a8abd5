"""Tile grid geometry and the tile-major -> image reshuffle.

Counterpart of TileGrid and tiles_to_image in
fusionsense_tpu/render/composite.py (the XLA compositor itself belongs to
the dense backend, ROADMAP A11).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TileGrid(NamedTuple):
    width: int
    height: int
    tile_size: int

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def pixels_per_tile(self) -> int:
        return self.tile_size * self.tile_size


def tiles_to_image(tiled: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(T, P, C) or (T, P) tile-major -> (H, W, C) / (H, W) image, cropped."""
    squeeze = tiled.ndim == 2
    if squeeze:
        tiled = tiled[..., None]
    ts, ty, tx = grid.tile_size, grid.tiles_y, grid.tiles_x
    C = tiled.shape[-1]
    img = (tiled.reshape(ty, tx, ts, ts, C).permute(0, 2, 1, 3, 4)
           .reshape(ty * ts, tx * ts, C))[: grid.height, : grid.width]
    return img[..., 0] if squeeze else img
