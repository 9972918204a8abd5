"""Tile grid geometry, the tile-major -> image reshuffle, and the dense
`jax` backend's compositor.

Counterpart of fusionsense_tpu/render/composite.py. The `jax` backend is
plain tensor code (XLA in the JAX package, no kernel): per tile, log alpha
is one (P, 6) x (6, K) product of quadratic pixel features and per-Gaussian
coefficients, transmittance an exclusive cumsum of log1p(-alpha), and the
blend one (P, K) x (K, C) product. Autograd provides the backward. Tiles go
in chunks of `tile_chunk`, each under torch.utils.checkpoint, so only one
chunk's (t, P, K) intermediates are alive at a time.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
LOG_ALPHA_MAX = math.log(ALPHA_MAX)


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


def pixel_features(grid: TileGrid, device) -> torch.Tensor:
    """(num_tiles, P, 6) quadratic pixel features [x^2, xy, y^2, x, y, 1] at
    the pixel centers (integer + 0.5), tile-major."""
    ts, ty, tx = grid.tile_size, grid.tiles_y, grid.tiles_x
    local = torch.arange(ts, dtype=torch.float32, device=device) + 0.5
    ly, lx = torch.meshgrid(local, local, indexing="ij")
    ox = (torch.arange(tx, dtype=torch.float32, device=device) * ts)[None, :, None, None]
    oy = (torch.arange(ty, dtype=torch.float32, device=device) * ts)[:, None, None, None]
    px = (ox + lx).expand(ty, tx, ts, ts).reshape(ty * tx, ts * ts)
    py = (oy + ly).expand(ty, tx, ts, ts).reshape(ty * tx, ts * ts)
    return torch.stack([px * px, px * py, py * py, px, py,
                        torch.ones_like(px)], dim=-1)


def _composite_chunk(feats: torch.Tensor, coeffs: torch.Tensor,
                     channels: torch.Tensor):
    """feats (t, P, 6), coeffs (t, K, 6), channels (t, K, C) ->
    (out (t, P, C), alpha (t, P))."""
    logits = torch.einsum("tpf,tkf->tpk", feats, coeffs)
    alpha = torch.exp(torch.clamp_max(logits, LOG_ALPHA_MAX))
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    log_t = torch.log1p(-alpha)
    cum = torch.cumsum(log_t, dim=-1)
    w = alpha * torch.exp(cum - log_t)
    out = torch.einsum("tpk,tkc->tpc", w, channels)
    return out, 1.0 - torch.exp(cum[..., -1])


def composite_tiles(feats: torch.Tensor, tile_coeffs: torch.Tensor,
                    tile_channels: torch.Tensor, *, tile_chunk: int = 64):
    """Chunked, rematerialised compositing over all tiles: feats (T, P, 6),
    tile_coeffs (T, K, 6), tile_channels (T, K, C) -> (out (T, P, C),
    alpha (T, P))."""
    T = feats.shape[0]
    chunk = min(tile_chunk, T)
    outs, alphas = [], []
    for s in range(0, T, chunk):
        args = (feats[s:s + chunk], tile_coeffs[s:s + chunk],
                tile_channels[s:s + chunk])
        if torch.is_grad_enabled():
            # the chunk draws nothing random: no RNG state to keep, and
            # reading it is refused inside a CUDA graph capture
            o, a = checkpoint(_composite_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            o, a = _composite_chunk(*args)
        outs.append(o)
        alphas.append(a)
    return torch.cat(outs), torch.cat(alphas)


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
