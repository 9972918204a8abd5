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

`rasterize` is `prepare` (the per-Gaussian preprocess), `render_tiles`
over the whole tile grid (`tile_table`: the backend's layout, table and
dead rows, then its compositor) and `image_outputs`. The sharded step
(parallel/sharded.py) calls `render_tiles` for its block of tiles.

Gradients reach means/quats/scales/opacities/colors/normals through
autograd; the `mean2d_tap` and `absgrad_tap` zero inputs surface the
per-Gaussian signed and (pallas, flat) absolute screen-position gradients
(gsplat's absgrad).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.core.transforms import normalize, quat_to_rotmat
from fusionsense_tpu_torch.device import check_on, resolve_device
from fusionsense_tpu_torch.render.binning import (
    FlatBins, TileBins, auto_expand_budget, bin_gaussians, flat_bin_gaussians,
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


def prepare(means, quats, scales, opacities, colors, camera, cfg, normals,
            mean2d_tap) -> Prepared:
    """Projection and the per-Gaussian blended channels, for every backend:
    render/preprocess.py (its kernel pair for CUDA tensors)."""
    with span("fs.project"):
        return preprocess(means, quats, scales, opacities, colors, camera,
                          cfg, normals, mean2d_tap)


def _dead_row(width: int, device) -> torch.Tensor:
    """A table row no pixel sees: log_op (column 5) -1e10, else 0."""
    dead = torch.zeros((width,), device=device)
    dead[5].fill_(-1e10)   # a fill, not a copy from the host
    return dead


def _gaussian_table(pre: Prepared, absgrad_tap: Optional[torch.Tensor]):
    """(N, 8 + Cpad) rows [mx, my, ca, cb, cc, log_op, abs_tap_x, abs_tap_y,
    chan..., pad] and the dead row."""
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
    return table_n, _dead_row(table_n.shape[-1], dev)


def _with_dead_rows(sel: torch.Tensor, live: torch.Tensor,
                    dead: torch.Tensor) -> torch.Tensor:
    """Gathered pair rows (0 where not `live`) with the dead row there."""
    return sel + torch.where(live[..., None], torch.zeros_like(dead), dead)


def _block_rows(x: torch.Tensor, tile_lo: int, n: int, fill) -> torch.Tensor:
    """Rows [tile_lo, tile_lo + n) of a per-tile array, `fill` past its end."""
    short = tile_lo + n - x.shape[0]
    if short > 0:
        x = torch.cat([x, torch.full((short,) + x.shape[1:], fill,
                                     dtype=x.dtype, device=x.device)])
    return x[tile_lo:tile_lo + n]


def flat_layout(proj, camera: Camera, cfg: RasterizeConfig, *,
                tile_lo: int = 0, num_tiles_local: Optional[int] = None,
                n: Optional[int] = None) -> FlatBins:
    """The flat backend's layout of the tiles [tile_lo, tile_lo +
    num_tiles_local) (the whole grid by default): a pair budget of
    tile_capacity pairs per tile of the block, block-rounded; the landing
    map unless flat_grad_transpose is "scatter"; the compact enumeration
    when its expand budget is below n x the cover window's slots (n:
    proj's rows, unless given: the bin cache weighs it against the
    configured capacity, as the JAX trainer does)."""
    T = (TileGrid(camera.width, camera.height, cfg.tile_size).num_tiles
         if num_tiles_local is None else num_tiles_local)
    B = cfg.pallas_chunk
    PB = -(-cfg.tile_capacity * T // B) * B
    N = proj.mean2d.shape[0] if n is None else n
    with span("fs.bin"):
        return flat_bin_gaussians(
            proj.mean2d.detach(), proj.radius.detach(), proj.depth.detach(),
            width=camera.width, height=camera.height, tile_size=cfg.tile_size,
            pair_budget=PB, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            block=B, tile_lo=tile_lo, num_tiles_local=num_tiles_local,
            compute_landing=cfg.flat_grad_transpose != "scatter",
            expand_budget=auto_expand_budget(
                PB, N, cfg.max_tiles_per_gaussian, B))


def _dense_bins(proj, camera: Camera, cfg: RasterizeConfig) -> TileBins:
    with span("fs.bin"):
        return bin_gaussians(
            proj.mean2d.detach(), proj.radius.detach(), proj.depth.detach(),
            width=camera.width, height=camera.height,
            tile_size=cfg.tile_size, tile_capacity=cfg.tile_capacity,
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian)


class TileTable(NamedTuple):
    """One tile block's pairs as its backend's compositor takes them."""

    table: torch.Tensor      # flat (PB, 8 + Cpad), pallas (T_loc, K, 8 + Cpad)
    #                          pair rows; jax (T_loc, K, 6) alpha coefficients;
    #                          dead slots have log_op -1e10
    bins: object             # FlatBins of the block, or TileBins of the grid
    counts: Optional[torch.Tensor]  # pallas: (T_loc,) int32 live slots
    nchan: int               # channels before padding
    composite: Callable      # () -> (out (T_loc, P, >= nchan), alpha (T_loc, P))


def tile_table(pre: Prepared, camera: Camera, cfg: RasterizeConfig, *,
               tile_lo: int = 0, num_tiles_local: Optional[int] = None,
               absgrad_tap: Optional[torch.Tensor] = None,
               bins=None) -> TileTable:
    """The table of the tiles [tile_lo, tile_lo + num_tiles_local) (the
    whole grid by default) in cfg.backend's layout, with that backend's
    compositor bound to it:

    - "flat": the block's flat layout, one (PB, 8 + Cpad) gather, K1/K2;
    - "pallas": the grid's dense bins, the block's (T_loc, K, 8 + Cpad)
      gather, K3/K4 at the block's global tile ids;
    - "jax": the block's gathered quadratic coefficients and channels,
      composite_tiles.

    A gather's backward reads the landing map (the flat one unless
    flat_grad_transpose is "scatter", which scatters instead); a block's
    dense landing map keeps only its own slots, the other blocks' pairs
    reaching the parameters through theirs. `bins` may hold the whole
    grid's FlatBins (the trainer's bin cache)."""
    grid = TileGrid(camera.width, camera.height, cfg.tile_size)
    T_loc = grid.num_tiles if num_tiles_local is None else num_tiles_local
    whole = tile_lo == 0 and T_loc == grid.num_tiles
    nchan = pre.channels.shape[-1]
    geo = (grid.tiles_x, cfg.tile_size, cfg.pallas_chunk, cfg.blend_bf16)
    if cfg.backend == "flat":
        fb = bins if bins is not None else flat_layout(
            pre.proj, camera, cfg, tile_lo=tile_lo,
            num_tiles_local=num_tiles_local)
        table_n, dead = _gaussian_table(pre, absgrad_tap)
        if fb.landing is None:
            sel = _FlatSelectScatter.apply(table_n, fb.gauss_ids, fb.valid)
        else:
            sel = _TileSelect.apply(table_n, fb.gauss_ids, fb.valid,
                                    fb.landing)
        table = _with_dead_rows(sel, fb.valid, dead)
        return TileTable(table, fb, None, nchan, functools.partial(
            flat_composite, table, fb.blk_tile, fb.blk_count, T_loc, *geo,
            tile_lo=tile_lo))

    tb = _dense_bins(pre.proj, camera, cfg)
    idx, mask = torch.clamp_min(tb.indices, 0), tb.mask
    if not whole:
        idx = _block_rows(idx, tile_lo, T_loc, 0)
        mask = _block_rows(mask, tile_lo, T_loc, False)
    if cfg.backend == "pallas":
        landing = tb.landing
        if not whole:
            K = tb.indices.shape[1]
            loc = landing - tile_lo * K
            landing = torch.where((loc >= 0) & (loc < T_loc * K), loc,
                                  torch.full_like(loc, -1))
        table_n, dead = _gaussian_table(pre, absgrad_tap)
        table = _with_dead_rows(_TileSelect.apply(table_n, idx, mask, landing),
                                mask, dead)
        counts = mask.sum(dim=-1, dtype=torch.int32)
        tile_ids = torch.arange(T_loc, dtype=torch.int32, device=table.device)
        if tile_lo:
            tile_ids = tile_ids + tile_lo
        return TileTable(table, tb, counts, nchan, functools.partial(
            composite2, table, counts, tile_ids, *geo))

    idx = idx.long()
    m = mask[..., None]
    tile_chan = torch.where(m, pre.channels[idx], torch.zeros((), device=m.device))
    coeff = alpha_coefficients(pre.mean2d, pre.proj.conic, pre.op,
                               pre.proj.valid)
    tile_coeff = torch.where(m, coeff[idx], _dead_row(6, m.device))
    feats = pixel_features(grid, m.device)
    if not whole:
        feats = _block_rows(feats, tile_lo, T_loc, 0.0)
    return TileTable(tile_coeff, tb, None, nchan, functools.partial(
        composite_tiles, feats, tile_coeff, tile_chan,
        tile_chunk=cfg.tile_chunk))


class TileRender(NamedTuple):
    """One tile block, composited."""

    out: torch.Tensor        # (T_loc, P, C) channels [rgb, depth_acc, normal]
    alpha: torch.Tensor      # (T_loc, P) accumulation
    bins: object             # FlatBins or TileBins: overflow, truncated,
    #                          trunc_by_win
    pairs_used: Optional[torch.Tensor]  # flat: block-aligned live pairs;
    #                                     None for the dense backends


def render_tiles(pre: Prepared, camera: Camera, cfg: RasterizeConfig, *,
                 tile_lo: int = 0, num_tiles_local: Optional[int] = None,
                 absgrad_tap: Optional[torch.Tensor] = None,
                 bins=None) -> TileRender:
    """Composite the tiles [tile_lo, tile_lo + num_tiles_local) (the whole
    grid by default) of one camera from its Prepared (tile_table)."""
    tt = tile_table(pre, camera, cfg, tile_lo=tile_lo,
                    num_tiles_local=num_tiles_local, absgrad_tap=absgrad_tap,
                    bins=bins)
    with span("fs.composite"):
        out, alpha = tt.composite()
    if out.shape[-1] > tt.nchan:
        out = out[..., :tt.nchan]
    return TileRender(out, alpha, tt.bins,
                      tt.bins.used if isinstance(tt.bins, FlatBins) else None)


def image_outputs(out_tiled: torch.Tensor, alpha_tiled: torch.Tensor,
                  grid: TileGrid,
                  background: Optional[torch.Tensor] = None) -> dict:
    """RenderOutputs' rgb, depth, normal and alpha from the grid's tiled
    channels and alpha: the expected depth, and the background under what
    alpha leaves."""
    img = tiles_to_image(out_tiled, grid)
    alpha = tiles_to_image(alpha_tiled, grid)
    rgb = img[..., 0:3]
    depth = expected_depth(img[..., 3], alpha)
    normal = img[..., 4:7]
    if background is not None:
        rgb = rgb + (1.0 - alpha)[..., None] * background
    return dict(rgb=rgb, depth=depth, normal=normal, alpha=alpha)


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

    pre = prepare(means, quats, scales, opacities, colors, camera, cfg,
                  normals, mean2d_tap)
    r = render_tiles(pre, camera, cfg, absgrad_tap=absgrad_tap, bins=bins)
    return RenderOutputs(
        **image_outputs(r.out, r.alpha, grid, background),
        mean2d=pre.proj.mean2d, radius=pre.proj.radius,
        overflow=r.bins.overflow, truncated=r.bins.truncated,
        trunc_by_win=r.bins.trunc_by_win,
        pairs_used=i0 if r.pairs_used is None else r.pairs_used)
