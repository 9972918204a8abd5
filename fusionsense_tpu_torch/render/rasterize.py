"""Differentiable Gaussian rasterizer: project -> bin -> table gather ->
composite, with the JAX package's three backends.

Counterpart of fusionsense_tpu/render/rasterize.py. One call renders RGB +
expected depth + world-space normal + alpha. Backends:

- "jax" (the default): dense (T, K) binning, then the plain-tensor
  compositor of render/composite.py on quadratic alpha coefficients;
- "pallas": dense (T, K) binning, one (T, K, 8 + C) table gather, kernels
  K3/K4 (render/composite2.py);
- "flat": block-aligned segmented pairs, one (PB, 8 + C) table gather,
  kernels K1/K2 (render/flat_composite.py).

Gradients reach means/quats/scales/opacities/colors/normals through
autograd; the `mean2d_tap` and `absgrad_tap` zero inputs surface the
per-Gaussian signed and (pallas, flat) absolute screen-position gradients
(gsplat's absgrad).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.core.transforms import normalize, quat_to_rotmat
from fusionsense_tpu_torch.device import check_on, resolve_device
from fusionsense_tpu_torch.render.binning import (
    auto_expand_budget, bin_gaussians, flat_bin_gaussians,
)
from fusionsense_tpu_torch.render.composite import (
    TileGrid, composite_tiles, pixel_features, tiles_to_image,
)
from fusionsense_tpu_torch.render.composite2 import composite2
from fusionsense_tpu_torch.render.flat_composite import flat_composite
from fusionsense_tpu_torch.render.preprocess import Prepared, preprocess
from fusionsense_tpu_torch.render.project import alpha_coefficients
from fusionsense_tpu_torch.utils.profiling import span

BACKENDS = ("jax", "pallas", "flat")


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer knobs, with the JAX package's names and defaults."""

    tile_size: int = 16
    tile_capacity: int = 512     # dense: K per tile; flat: mean pairs per tile
    max_tiles_per_gaussian: int = 32
    tile_chunk: int = 64
    near: float = 0.01
    far: float = 1e10
    eps2d: float = 0.3
    antialiased: bool = False
    sh_degree: int = 3
    radius_clip: float = 0.0
    backend: str = "jax"
    pallas_chunk: int = 128
    blend_bf16: bool = False
    flat_grad_transpose: str = "landing"   # "landing" | "scatter"


def check_slice(cfg: RasterizeConfig) -> None:
    """Raise on rasterizer options whose code is not ported yet."""
    if cfg.backend not in BACKENDS:
        raise NotImplementedError(
            f"backend={cfg.backend!r}: the backends are {BACKENDS}")
    if cfg.flat_grad_transpose not in ("landing", "scatter"):
        raise NotImplementedError(
            f"flat_grad_transpose={cfg.flat_grad_transpose!r}: only the "
            "'landing' and 'scatter' transposes exist (ROADMAP A8)")


def expected_depth(depth_acc: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Accumulated depth over accumulation (gsplat "ED"), with the 1e-3
    denominator floor of the reference; empty pixels report 0."""
    return torch.where(alpha > 0, depth_acc / torch.clamp_min(alpha, 1e-3),
                       torch.zeros_like(depth_acc))


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor          # (H, W, 3)
    depth: torch.Tensor        # (H, W) expected depth
    normal: torch.Tensor       # (H, W, 3) composited world-space normal
    alpha: torch.Tensor        # (H, W) accumulation
    mean2d: torch.Tensor       # (N, 2) screen positions
    radius: torch.Tensor       # (N,) screen radii (0 = culled)
    overflow: torch.Tensor     # scalar: pairs dropped past K / the budget
    truncated: torch.Tensor    # scalar: per-Gaussian cover truncation
    trunc_by_win: torch.Tensor  # (5,) counterfactual truncation, windows 1..5
    pairs_used: torch.Tensor   # scalar: flat block-aligned live pair total
    #                            (0 for the dense backends)


def gaussian_flat_normals(quats: torch.Tensor, scales: torch.Tensor,
                          means: torch.Tensor,
                          cam_origin: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian normal = rotation axis of the smallest scale, flipped to
    face the camera."""
    R = quat_to_rotmat(quats)                               # columns = axes
    min_axis = torch.argmin(scales, dim=-1)
    n = torch.gather(R, 2, min_axis[:, None, None].expand(-1, 3, 1))[..., 0]
    viewdir = normalize(means - cam_origin)
    flip = torch.sum(n * viewdir, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


class _TileSelect(torch.autograd.Function):
    """(N, W) table -> (..., W) pair rows at (...) index arrays (flat (PB,) or
    dense (T, K)), masked slots 0. The backward is a gather from the
    Gaussian side through the landing map."""

    @staticmethod
    def forward(ctx, table_n, gauss_ids, valid, landing):
        ctx.save_for_backward(landing)
        ctx.n = table_n.shape[0]
        return torch.where(valid[..., None], table_n[gauss_ids],
                           torch.zeros((), dtype=table_n.dtype,
                                       device=table_n.device))

    @staticmethod
    def backward(ctx, g):
        (landing,) = ctx.saved_tensors
        C = landing.shape[1]
        flat = g.reshape(-1, g.shape[-1])
        l = landing.reshape(-1).long()
        gp = flat[torch.clamp_min(l, 0)] * (l >= 0)[:, None]
        return gp.reshape(ctx.n, C, -1).sum(dim=1), None, None, None


class _FlatSelectScatter(torch.autograd.Function):
    """(N, W) table -> (PB, W) flat pair rows, masked slots 0. The backward
    is one index_add_ of the PB gradient rows keyed by gauss_ids."""

    @staticmethod
    def forward(ctx, table_n, gauss_ids, valid):
        ctx.save_for_backward(gauss_ids, valid)
        ctx.n = table_n.shape[0]
        return torch.where(valid[:, None], table_n[gauss_ids],
                           torch.zeros((), dtype=table_n.dtype,
                                       device=table_n.device))

    @staticmethod
    def backward(ctx, g):
        gauss_ids, valid = ctx.saved_tensors
        n = ctx.n
        g = torch.where(valid[:, None], g, torch.zeros_like(g))
        ids = torch.where(valid, gauss_ids.long(), torch.full_like(
            gauss_ids, n, dtype=torch.long))
        acc = torch.zeros((n + 1, g.shape[1]), dtype=g.dtype, device=g.device)
        acc.index_add_(0, ids, g)
        return acc[:n], None, None


def pair_budget(cfg: RasterizeConfig, grid: TileGrid) -> int:
    """Flat pair budget: tile_capacity pairs per tile, block-rounded."""
    B = cfg.pallas_chunk
    return -(-cfg.tile_capacity * grid.num_tiles // B) * B


def _prepare(means, quats, scales, opacities, colors, camera, cfg, normals,
             mean2d_tap) -> Prepared:
    """Projection and the per-Gaussian blended channels, for every backend:
    render/preprocess.py (its kernel pair for CUDA tensors)."""
    with span("fs.project"):
        return preprocess(means, quats, scales, opacities, colors, camera,
                          cfg, normals, mean2d_tap)


def _gaussian_table(pre: Prepared, absgrad_tap: Optional[torch.Tensor]):
    """(N, 8 + Cpad) rows [mx, my, ca, cb, cc, log_op, abs_tap_x, abs_tap_y,
    chan..., pad] and the dead row (log_op = -1e10, else 0)."""
    N = pre.mean2d.shape[0]
    dev = pre.mean2d.device
    nchan = pre.channels.shape[-1]
    pad_c = (-nchan) % 8
    log_op = torch.where(pre.proj.valid,
                         torch.log(torch.clamp_min(pre.op, 1e-12)),
                         torch.full_like(pre.op, -1e10))
    if absgrad_tap is None:
        absgrad_tap = torch.zeros((N, 2), device=dev)
    cols = [pre.mean2d, pre.proj.conic, log_op[:, None], absgrad_tap,
            pre.channels]
    if pad_c:
        cols.append(torch.zeros((N, pad_c), device=dev))
    table_n = torch.cat(cols, dim=-1)
    dead = torch.zeros((table_n.shape[-1],), device=dev)
    dead[5].fill_(-1e10)   # a fill, not a copy from the host
    return table_n, dead


class FlatTable(NamedTuple):
    """What K1 composites for one camera, before compositing."""

    table: torch.Tensor      # (PB, 8 + Cpad) flat pair rows, dead = log_op -1e10
    bins: object             # FlatBins of the layout
    proj: object             # Projected
    nchan: int               # channels before padding


def flat_table(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
               opacities: torch.Tensor, colors: torch.Tensor, camera: Camera,
               cfg: RasterizeConfig, *, normals: Optional[torch.Tensor] = None,
               mean2d_tap: Optional[torch.Tensor] = None,
               absgrad_tap: Optional[torch.Tensor] = None,
               bins=None) -> FlatTable:
    """Project, bin (unless `bins` is given) and gather the flat pair table
    [mx, my, ca, cb, cc, log_op, abs_tap_x, abs_tap_y, chan..., pad]."""
    N = means.shape[0]
    pre = _prepare(means, quats, scales, opacities, colors, camera, cfg,
                   normals, mean2d_tap)
    proj = pre.proj
    B = cfg.pallas_chunk
    PB = pair_budget(cfg, TileGrid(camera.width, camera.height, cfg.tile_size))
    if bins is not None:
        fb = bins
    else:
        with span("fs.bin"):
            fb = flat_bin_gaussians(
                proj.mean2d.detach(), proj.radius.detach(),
                proj.depth.detach(), width=camera.width, height=camera.height,
                tile_size=cfg.tile_size, pair_budget=PB,
                max_tiles_per_gaussian=cfg.max_tiles_per_gaussian, block=B,
                compute_landing=cfg.flat_grad_transpose != "scatter",
                expand_budget=auto_expand_budget(
                    PB, N, cfg.max_tiles_per_gaussian, B))
    table_n, dead = _gaussian_table(pre, absgrad_tap)
    if cfg.flat_grad_transpose == "scatter" or fb.landing is None:
        sel = _FlatSelectScatter.apply(table_n, fb.gauss_ids, fb.valid)
    else:
        sel = _TileSelect.apply(table_n, fb.gauss_ids, fb.valid, fb.landing)
    table = sel + torch.where(fb.valid[:, None], torch.zeros_like(dead), dead)
    return FlatTable(table=table, bins=fb, proj=proj,
                     nchan=pre.channels.shape[-1])


class DenseTable(NamedTuple):
    """What K3 composites for one camera, before compositing."""

    table: torch.Tensor      # (T, K, 8 + Cpad) tile rows, dead = log_op -1e10
    counts: torch.Tensor     # (T,) int32 live slots per tile
    bins: object             # TileBins of the layout
    proj: object             # Projected
    nchan: int               # channels before padding


def _dense_bins(proj, camera: Camera, cfg: RasterizeConfig):
    with span("fs.bin"):
        return bin_gaussians(
            proj.mean2d.detach(), proj.radius.detach(), proj.depth.detach(),
            width=camera.width, height=camera.height,
            tile_size=cfg.tile_size, tile_capacity=cfg.tile_capacity,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)


def dense_table(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
                opacities: torch.Tensor, colors: torch.Tensor, camera: Camera,
                cfg: RasterizeConfig, *, normals: Optional[torch.Tensor] = None,
                mean2d_tap: Optional[torch.Tensor] = None,
                absgrad_tap: Optional[torch.Tensor] = None) -> DenseTable:
    """Project, bin densely and gather the (T, K, 8 + Cpad) tile table of the
    `pallas` backend: one gather, whose backward is a landing-map gather."""
    pre = _prepare(means, quats, scales, opacities, colors, camera, cfg,
                   normals, mean2d_tap)
    tb = _dense_bins(pre.proj, camera, cfg)
    table_n, dead = _gaussian_table(pre, absgrad_tap)
    sel = _TileSelect.apply(table_n, torch.clamp_min(tb.indices, 0), tb.mask,
                            tb.landing)
    table = sel + torch.where(tb.mask[..., None], torch.zeros_like(dead), dead)
    counts = tb.mask.sum(dim=-1, dtype=torch.int32)
    return DenseTable(table=table, counts=counts, bins=tb, proj=pre.proj,
                      nchan=pre.channels.shape[-1])


def _xla_composite(means, quats, scales, opacities, colors, camera, cfg,
                   normals, mean2d_tap):
    """The `jax` backend: gathered quadratic coefficients and channels into
    composite_tiles. Returns (out (T, P, C), alpha (T, P), bins, proj)."""
    pre = _prepare(means, quats, scales, opacities, colors, camera, cfg,
                   normals, mean2d_tap)
    proj = pre.proj
    tb = _dense_bins(proj, camera, cfg)
    idx = torch.clamp_min(tb.indices, 0).long()
    m = tb.mask[..., None]
    tile_chan = torch.where(m, pre.channels[idx], torch.zeros((), device=m.device))
    coeff = alpha_coefficients(pre.mean2d, proj.conic, pre.op, proj.valid)
    dead = torch.zeros((6,), device=m.device)
    dead[5].fill_(-1e10)   # a fill, not a copy from the host
    tile_coeff = torch.where(m, coeff[idx], dead)
    feats = pixel_features(TileGrid(camera.width, camera.height, cfg.tile_size),
                           m.device)
    with span("fs.composite"):
        out, alpha = composite_tiles(feats, tile_coeff, tile_chan,
                                     tile_chunk=cfg.tile_chunk)
    return out, alpha, tb, proj


def rasterize(means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
              opacities: torch.Tensor, colors: torch.Tensor, camera: Camera,
              cfg: RasterizeConfig = RasterizeConfig(), *,
              normals: Optional[torch.Tensor] = None,
              background: Optional[torch.Tensor] = None,
              mean2d_tap: Optional[torch.Tensor] = None,
              absgrad_tap: Optional[torch.Tensor] = None,
              bins=None, device=None) -> RenderOutputs:
    """Render one camera. Runs on `device` (the card by default); every
    input must already lie there. `bins` may hold a precomputed FlatBins
    (the trainer's bin cache, flat backend only)."""
    check_slice(cfg)
    dev = resolve_device(device)
    check_on(dev, means=means, quats=quats, scales=scales,
             opacities=opacities, colors=colors, viewmat=camera.viewmat)
    grid = TileGrid(width=camera.width, height=camera.height,
                    tile_size=cfg.tile_size)
    H, W = camera.height, camera.width
    i0 = torch.zeros((), dtype=torch.int32, device=dev)

    if means.shape[0] == 0:
        zero = torch.zeros((H, W), device=dev)
        rgb = torch.zeros((H, W, 3), device=dev)
        if background is not None:
            rgb = rgb + background
        return RenderOutputs(
            rgb=rgb, depth=zero, normal=torch.zeros((H, W, 3), device=dev),
            alpha=zero, mean2d=torch.zeros((0, 2), device=dev),
            radius=torch.zeros((0,), device=dev), overflow=i0, truncated=i0,
            trunc_by_win=torch.zeros((5,), dtype=torch.int32, device=dev),
            pairs_used=i0)

    kw = dict(normals=normals, mean2d_tap=mean2d_tap)
    if cfg.backend == "flat":
        ft = flat_table(means, quats, scales, opacities, colors, camera, cfg,
                        absgrad_tap=absgrad_tap, bins=bins, **kw)
        fb, proj = ft.bins, ft.proj
        with span("fs.composite"):
            out_tiled, alpha_tiled = flat_composite(
                ft.table, fb.blk_tile, fb.blk_count, grid.num_tiles,
                grid.tiles_x, cfg.tile_size, cfg.pallas_chunk, cfg.blend_bf16)
        out_tiled = out_tiled[..., :ft.nchan]
        pairs_used = fb.used
    elif cfg.backend == "pallas":
        dt = dense_table(means, quats, scales, opacities, colors, camera, cfg,
                         absgrad_tap=absgrad_tap, **kw)
        fb, proj = dt.bins, dt.proj
        with span("fs.composite"):
            out_tiled, alpha_tiled = composite2(
                dt.table, dt.counts,
                torch.arange(grid.num_tiles, dtype=torch.int32, device=dev),
                grid.tiles_x, cfg.tile_size, cfg.pallas_chunk, cfg.blend_bf16)
        out_tiled = out_tiled[..., :dt.nchan]
        pairs_used = i0
    else:
        out_tiled, alpha_tiled, fb, proj = _xla_composite(
            means, quats, scales, opacities, colors, camera, cfg, **kw)
        pairs_used = i0

    img = tiles_to_image(out_tiled, grid)
    alpha = tiles_to_image(alpha_tiled, grid)
    rgb = img[..., 0:3]
    depth = expected_depth(img[..., 3], alpha)
    normal = img[..., 4:7]
    if background is not None:
        rgb = rgb + (1.0 - alpha)[..., None] * background
    return RenderOutputs(rgb=rgb, depth=depth, normal=normal, alpha=alpha,
                         mean2d=proj.mean2d, radius=proj.radius,
                         overflow=fb.overflow, truncated=fb.truncated,
                         trunc_by_win=fb.trunc_by_win, pairs_used=pairs_used)
