"""Tile binning: depth-sorted (tile, gaussian) pairs, in the dense
(num_tiles, tile_capacity) layout of the `jax`/`pallas` backends or as
block-aligned per-tile segments of one pair-budget array (`flat`).

Counterpart of fusionsense_tpu/render/binning.py (TileBins, bin_gaussians,
FlatBins, auto_expand_budget, flat_bin_gaussians), with its 16-bit
log-depth key, the dense N*C and the compact expand-budget enumerations, the
block maps and the landing maps. Where the reference finds a sorted pair's
segment head, block-aligned start or compact row owner by a running max or
min, the port reads the same value from the per-tile offsets or the
per-Gaussian inclusive ends: a gather in place of a serial scan, which
torch runs in one CTA on the device. Index rules differ between the
frameworks: a JAX gather clamps and a `mode="drop"` scatter drops an
out-of-range index, while torch raises (CPU) or asserts on the device
(CUDA). Every index below is clipped or masked before use, and the drop
scatter writes into one spare slot that is then cut off. Sorts are stable
(torch.sort(stable=True)); the JAX reference's sort_key_val gives ties no
guaranteed order (ROADMAP F1).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

DEPTH_BITS = 16


class TileBins(NamedTuple):
    indices: torch.Tensor       # (T, K) int32 Gaussian per slot, -1 empty
    mask: torch.Tensor          # (T, K) bool slot holds a live pair
    overflow: torch.Tensor      # scalar: pairs dropped past a tile's K
    truncated: torch.Tensor     # scalar: pairs dropped by the cover window
    landing: torch.Tensor       # (N, C) pair -> flat tile * K + slot, -1 dropped
    trunc_by_win: torch.Tensor  # (5,) counterfactual truncation telemetry


class FlatBins(NamedTuple):
    gauss_ids: torch.Tensor     # (PB,) gaussian index per flat slot (clipped)
    valid: torch.Tensor         # (PB,) slot holds a live pair
    blk_tile: torch.Tensor      # (nb,) local tile of each block; T = dummy
    blk_first: torch.Tensor     # (nb,) 1 if first block of its tile run
    blk_count: torch.Tensor     # (nb,) live pairs in this block (0..B)
    landing: Optional[torch.Tensor]  # (N, C) pair -> flat slot, -1 if dropped
    overflow: torch.Tensor      # scalar: pairs dropped past the budget
    truncated: torch.Tensor     # scalar: pairs dropped by the cover window
    trunc_by_win: torch.Tensor  # (5,) counterfactual truncation telemetry
    used: torch.Tensor          # scalar: block-aligned live pair total


def cover_window(max_tiles_per_gaussian: int) -> int:
    """Side of the static square cover window. The compact enumeration packs
    window slots as dy*8+dx, so windows wider than 8 are refused (ROADMAP
    F2: the reference silently corrupts tile ids there)."""
    win = max(1, int(math.isqrt(max_tiles_per_gaussian)))
    if win > 8:
        raise ValueError(
            f"max_tiles_per_gaussian={max_tiles_per_gaussian} gives a cover "
            f"window of {win} > 8 tiles, which the dy*8+dx packing cannot hold")
    return win


def auto_expand_budget(pair_budget: int, n: int, max_tiles_per_gaussian: int,
                       block: int = 128) -> int | None:
    """Compact-expansion budget (1.5x the pair budget, block-rounded), or
    None when the dense N*C enumeration is already at least as small."""
    win = max(1, int(math.isqrt(max_tiles_per_gaussian)))
    eb = -(-(pair_budget * 3 // 2) // block) * block
    return eb if eb < n * win * win else None


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def _check_key_width(num_tiles: int) -> None:
    if (num_tiles + 1) << DEPTH_BITS >= 2 ** 31:
        raise ValueError("key overflow: too many tiles for a 32-bit key")


class _PairGeometry(NamedTuple):
    valid: torch.Tensor          # (N,) radius > 0
    rank: torch.Tensor           # (N,) int64 16-bit log-depth rank
    tx0: torch.Tensor            # (N,) int64 first covered tile column
    ty0: torch.Tensor            # (N,) int64 first covered tile row
    bw: torch.Tensor             # (N,) int64 covered tile columns
    bh: torch.Tensor             # (N,) int64 covered tile rows
    truncated: torch.Tensor      # pairs the win x win window drops
    trunc_by_win: torch.Tensor   # (5,) the same at windows 1..5


def _pair_geometry(mean2d, radius, depth, tile_size, tiles_x, tiles_y,
                   win) -> _PairGeometry:
    """Depth ranks, tile bounding boxes and cover-truncation telemetry, as
    both layouts of the reference compute them."""
    valid = radius > 0
    big = torch.finfo(torch.float32).max
    d_safe = torch.clamp_min(depth, 1e-12)
    log_d = torch.log(torch.where(valid, d_safe, torch.full_like(d_safe, big)))
    lo = torch.min(log_d)
    hi = torch.max(torch.where(valid, log_d, torch.full_like(log_d, -big)))
    span = torch.clamp_min(hi - lo, 1e-12)
    n_q = (1 << DEPTH_BITS) - 1
    rank = torch.clamp((log_d - lo) / span * n_q, 0, n_q).to(torch.int64)

    def tile_of(v, hi_t):
        return torch.clamp(torch.floor(v / tile_size), 0, hi_t - 1).to(torch.int64)

    tx0 = tile_of(mean2d[:, 0] - radius, tiles_x)
    ty0 = tile_of(mean2d[:, 1] - radius, tiles_y)
    bw = tile_of(mean2d[:, 0] + radius, tiles_x) - tx0 + 1
    bh = tile_of(mean2d[:, 1] + radius, tiles_y) - ty0 + 1
    zero = torch.zeros_like(bw)
    cover = torch.where(valid, torch.clamp_min(bw, 0) * torch.clamp_min(bh, 0), zero)

    def trunc_at(w):
        return torch.sum(cover - torch.where(
            valid, torch.clamp_max(bw, w) * torch.clamp_max(bh, w), zero))

    return _PairGeometry(valid, rank, tx0, ty0, bw, bh, trunc_at(win),
                         torch.stack([trunc_at(w) for w in range(1, 6)]))


@torch.no_grad()
def flat_bin_gaussians(mean2d: torch.Tensor, radius: torch.Tensor,
                       depth: torch.Tensor, *, width: int, height: int,
                       tile_size: int, pair_budget: int,
                       max_tiles_per_gaussian: int = 16, block: int = 128,
                       tile_lo: int = 0, num_tiles_local: int | None = None,
                       compute_landing: bool = True,
                       expand_budget: int | None = None) -> FlatBins:
    """Depth-sorted pairs laid out as block-aligned per-tile segments.

    tile_lo / num_tiles_local restrict the layout to a local tile range;
    compute_landing=False skips the landing map; expand_budget < N*C selects
    the compact live-pair enumeration (see the JAX docstring for the
    design). Integer outputs are int32, as in the reference."""
    dev = mean2d.device
    N = mean2d.shape[0]
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    num_tiles = tiles_x * tiles_y if num_tiles_local is None else num_tiles_local
    B = block
    PB = pair_budget
    if PB % B:
        raise ValueError("pair_budget must be a multiple of the kernel block")
    win = cover_window(max_tiles_per_gaussian)
    C = win * win
    _check_key_width(num_tiles)
    i64 = dict(dtype=torch.int64, device=dev)
    pg = _pair_geometry(mean2d, radius, depth, tile_size, tiles_x, tiles_y, win)
    valid, rank, tx0, ty0, bw, bh = (pg.valid, pg.rank, pg.tx0, pg.ty0,
                                     pg.bw, pg.bh)
    zero = torch.zeros_like(bw)
    dead_key = num_tiles << DEPTH_BITS

    use_compact = expand_budget is not None and expand_budget < N * C
    if use_compact:
        EB = expand_budget
        w_live = torch.where(valid, torch.clamp_max(bw, win), zero)
        h_live = torch.where(valid, torch.clamp_max(bh, win), zero)
        c_live = w_live * h_live
        S = torch.cumsum(c_live, 0) - c_live                     # exclusive
        total_live = S[-1] + c_live[-1]
        # row -> gaussian: the first whose inclusive end passes the row;
        # rows past total_live keep the last live gaussian (0 if none)
        j = torch.arange(EB, **i64)
        gid = torch.arange(N, **i64)
        g_last = torch.max(torch.where(c_live > 0, gid, torch.zeros_like(gid)))
        g_of = torch.minimum(
            torch.searchsorted(S + c_live, j, right=True), g_last)
        r = j - S[g_of]
        live = j < total_live
        # window slot r of a w-wide window packed as dy*8+dx (0 where w = 0),
        # computed on the device: a host table would be a copy from the host
        rc = torch.clamp(r, 0, win * win - 1)
        wv = w_live[g_of]
        ws = torch.clamp_min(wv, 1)
        packed = torch.where(wv > 0, (rc // ws) * 8 + rc % ws,
                             torch.zeros_like(rc))
        dy_c = packed >> 3
        dx_c = packed & 7
        local_c = (ty0[g_of] + dy_c) * tiles_x + tx0[g_of] + dx_c - tile_lo
        pair_live = live & (local_c >= 0) & (local_c < num_tiles)
        lid_c = torch.clamp(local_c, 0, num_tiles - 1)
        flat_key = torch.where(pair_live, (lid_c << DEPTH_BITS) | rank[g_of],
                               torch.full_like(lid_c, dead_key))
        n_pairs = EB
        expand_dropped = torch.clamp_min(total_live - EB, 0)
    else:
        dxs = torch.arange(win, **i64)
        dys = torch.arange(win, **i64)
        tile_id = ((ty0[:, None, None] + dys[None, :, None]) * tiles_x
                   + tx0[:, None, None] + dxs[None, None, :])
        pair_ok = (valid[:, None, None]
                   & (dys[None, :, None] < bh[:, None, None])
                   & (dxs[None, None, :] < bw[:, None, None]))
        local_id = tile_id - tile_lo
        pair_ok = pair_ok & (local_id >= 0) & (local_id < num_tiles)
        lid = torch.clamp(local_id, 0, num_tiles - 1)
        key = torch.where(pair_ok, (lid << DEPTH_BITS) | rank[:, None, None],
                          torch.full_like(lid, dead_key))
        flat_key = key.reshape(-1)
        n_pairs = N * C

    sorted_key, sorted_pair = torch.sort(_i32(flat_key), stable=True)
    sorted_tile = sorted_key >> DEPTH_BITS                     # int32

    # per-tile raw and block-aligned segment offsets
    bounds = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev))
    starts, ends = bounds[:-1], bounds[1:]
    counts = ends - starts
    acounts = ((counts + B - 1) // B) * B
    astarts = torch.cat([torch.zeros(1, **i64), torch.cumsum(acounts, 0)[:-1]])
    total_aligned = astarts[-1] + acounts[-1]
    overflow = torch.sum(torch.clamp_min(
        torch.minimum(astarts + counts, total_aligned)
        - torch.clamp_min(astarts, PB), 0))

    # block maps
    nb = PB // B
    bs = torch.arange(nb, **i64) * B
    t_of = torch.clamp(torch.searchsorted(astarts, bs, right=True) - 1,
                       0, num_tiles - 1)
    real = bs < total_aligned
    blk_tile = torch.where(real, t_of, torch.full_like(t_of, num_tiles))
    blk_count = torch.where(
        real, torch.clamp(counts[t_of] - (bs - astarts[t_of]), 0, B),
        torch.zeros_like(t_of))
    blk_first = torch.cat([torch.ones(1, **i64),
                           (blk_tile[1:] != blk_tile[:-1]).to(torch.int64)])

    # flat gaussian ids
    blk_sorted_start = starts[t_of] + (bs - astarts[t_of])
    sorted_pos = torch.clamp(
        blk_sorted_start[:, None] + torch.arange(B, **i64)[None, :],
        0, n_pairs - 1).reshape(-1)
    if use_compact:
        gauss_ids = g_of[sorted_pair[sorted_pos]]
    else:
        gauss_ids = sorted_pair[sorted_pos] // C
    slot_in_blk = torch.arange(B, **i64).repeat(nb)
    valid_flat = slot_in_blk < blk_count.repeat_interleave(B)

    landing = None
    if compute_landing:
        # a sorted pair lands at its tile's aligned start plus its distance
        # from the tile's raw start; the dead tile is masked by `ok`
        i = torch.arange(n_pairs, **i64)
        shift = astarts - starts
        flat_pos = i + shift[torch.clamp(sorted_tile, 0, num_tiles - 1)]
        ok = (sorted_tile < num_tiles) & (flat_pos < PB)
        landing_sorted = torch.where(ok, flat_pos, torch.full_like(flat_pos, -1))
        # sorted_pair is a permutation: inverting it is one scatter
        landing_flat = torch.empty_like(landing_sorted)
        landing_flat[sorted_pair] = landing_sorted
        if use_compact:
            dy_s = torch.arange(win, **i64).repeat_interleave(win)[None, :]
            dx_s = torch.arange(win, **i64).repeat(win)[None, :]
            rr = dy_s * w_live[:, None] + dx_s
            slot_live = (dy_s < h_live[:, None]) & (dx_s < w_live[:, None])
            pos = S[:, None] + rr
            in_eb = slot_live & (pos < EB)
            landing = torch.where(in_eb, landing_flat[torch.clamp(pos, 0, EB - 1)],
                                  torch.full_like(pos, -1))
        else:
            landing = landing_flat.reshape(N, C)
        landing = _i32(landing)

    used = total_aligned
    if use_compact:
        used = torch.maximum(total_aligned, total_live)
        overflow = overflow + expand_dropped

    return FlatBins(gauss_ids=_i32(gauss_ids), valid=valid_flat,
                    blk_tile=_i32(blk_tile), blk_first=_i32(blk_first),
                    blk_count=_i32(blk_count), landing=landing,
                    overflow=_i32(overflow), truncated=_i32(pg.truncated),
                    trunc_by_win=_i32(pg.trunc_by_win), used=_i32(used))


@torch.no_grad()
def bin_gaussians(mean2d: torch.Tensor, radius: torch.Tensor,
                  depth: torch.Tensor, *, width: int, height: int,
                  tile_size: int, tile_capacity: int,
                  max_tiles_per_gaussian: int = 16) -> TileBins:
    """Dense (num_tiles, tile_capacity) layout: each tile keeps its nearest
    tile_capacity pairs of one fused (tile << 16 | depth rank) key sort over
    the static win x win cover; the rest count as `overflow`. No window
    packing is involved, so any window side is accepted."""
    dev = mean2d.device
    N = mean2d.shape[0]
    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    num_tiles = tiles_x * tiles_y
    K = tile_capacity
    win = max(1, int(math.isqrt(max_tiles_per_gaussian)))
    C = win * win
    _check_key_width(num_tiles)
    i64 = dict(dtype=torch.int64, device=dev)
    pg = _pair_geometry(mean2d, radius, depth, tile_size, tiles_x, tiles_y, win)

    ds = torch.arange(win, **i64)
    tile_id = ((pg.ty0[:, None, None] + ds[None, :, None]) * tiles_x
               + pg.tx0[:, None, None] + ds[None, None, :])
    pair_ok = (pg.valid[:, None, None] & (ds[None, :, None] < pg.bh[:, None, None])
               & (ds[None, None, :] < pg.bw[:, None, None]))
    key = torch.where(pair_ok, (tile_id << DEPTH_BITS) | pg.rank[:, None, None],
                      torch.full_like(tile_id, num_tiles << DEPTH_BITS))
    sorted_key, sorted_pair = torch.sort(_i32(key.reshape(-1)), stable=True)
    sorted_tile = sorted_key >> DEPTH_BITS

    bounds = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    overflow = torch.sum(torch.clamp_min(counts - K, 0))
    slot = torch.arange(K, **i64)[None, :]
    idx = sorted_pair[torch.clamp_max(starts[:, None] + slot, N * C - 1)] // C
    mask = slot < counts[:, None]
    idx = torch.where(mask, idx, torch.full_like(idx, -1))

    # landing: each sorted position's flat (tile * K + slot), found in sorted
    # order (slot = distance from its tile's head in `bounds`, whose last
    # entry heads the dead tile), then scattered back to pair order
    # (sorted_pair is a permutation)
    i = torch.arange(N * C, **i64)
    slot_sorted = i - bounds[sorted_tile]
    flat_sorted = torch.where((slot_sorted < K) & (sorted_tile < num_tiles),
                              sorted_tile * K + slot_sorted,
                              torch.full_like(i, -1))
    landing = torch.empty_like(flat_sorted)
    landing[sorted_pair] = flat_sorted
    return TileBins(indices=_i32(idx), mask=mask, overflow=_i32(overflow),
                    truncated=_i32(pg.truncated), landing=_i32(landing.reshape(N, C)),
                    trunc_by_win=_i32(pg.trunc_by_win))
