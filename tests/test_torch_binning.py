"""The port's bin_gaussians (dense) and flat_bin_gaussians against the JAX
reference, exactly.

Scenes are built so every live Gaussian has a unique 16-bit depth rank half
a quantum away from the rank boundaries (ROADMAP F1: the reference's
sort_key_val leaves the order of equal ranks unspecified, and a 1-ulp log
difference between frameworks must not move a rank). The cases are those
of tests/test_binning_compact.py: dense and compact enumerations, with and
without the landing map, a local tile shard and a truncating expand budget. The dense layout is held on
the same scenes at several cover windows and tile capacities, one of which
overflows. Both layouts are also held on the edges of the per-tile and
per-Gaussian lookups that place each sorted pair: empty tiles between
occupied ones, no live Gaussian, fewer live pairs than compact rows, and a
local tile range with pairs outside it on both sides; and no cummax or
cummin may run. Flat windows stay at 8 or less (F2); `used` is not compared
in compact plus tile-local mode (F3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.render.binning import bin_gaussians as dense_j
from fusionsense_tpu.render.binning import flat_bin_gaussians as bin_j
from fusionsense_tpu_torch.render.binning import (
    auto_expand_budget, bin_gaussians as dense_t, cover_window,
    flat_bin_gaussians as bin_t,
)

WIDTH, HEIGHT, TILE = 160, 96, 16
FIELDS = ("gauss_ids", "valid", "blk_tile", "blk_first", "blk_count",
          "landing", "overflow", "truncated", "trunc_by_win", "used")


def _scene(seed, n=300, cull_frac=0.3):
    rng = np.random.RandomState(seed)
    mean2d = np.stack([rng.uniform(-20, WIDTH + 20, n),
                       rng.uniform(-20, HEIGHT + 20, n)], -1).astype(np.float32)
    radius = rng.uniform(1.0, 40.0, n).astype(np.float32)
    radius[rng.uniform(size=n) < cull_frac] = 0.0
    return mean2d, radius, _depths(rng, radius)


def _depths(rng, radius):
    """Unique ranks among the live Gaussians, endpoints included, each half
    a quantum from its boundaries."""
    n = radius.shape[0]
    live = np.nonzero(radius > 0)[0]
    if len(live) < 2:   # every rank is 0
        return rng.uniform(0.5, 6.0, n).astype(np.float32)
    nq = 65535
    ranks = np.concatenate([[0, nq], rng.choice(np.arange(1, nq - 1),
                                                len(live) - 2, replace=False)])
    rng.shuffle(ranks)
    frac = np.where((ranks > 0) & (ranks < nq), ranks + 0.5, ranks) / nq
    lo, hi = np.log(0.5), np.log(6.0)
    depth = rng.uniform(0.5, 6.0, n)
    depth[live] = np.exp(lo + frac * (hi - lo))
    return depth.astype(np.float32)


def _clusters(seed, tiles=((0, 0), (4, 2), (9, 5)), per_tile=70):
    """Gaussians that each cover one tile of `tiles` alone, so the tiles
    between them are empty."""
    rng = np.random.RandomState(seed)
    centre = np.repeat(np.array(tiles, np.float32) * TILE + TILE / 2, per_tile, 0)
    mean2d = (centre + rng.uniform(-4, 4, centre.shape)).astype(np.float32)
    radius = rng.uniform(1.0, 3.0, len(centre)).astype(np.float32)
    return mean2d, radius, _depths(rng, radius)


EDGE_LAYOUTS = {
    "empty_tiles_between": lambda: _clusters(7),
    "no_live_gaussian": lambda: _scene(8, cull_frac=1.0),
    "few_live": lambda: _scene(9, cull_frac=0.95),
}


def _both(sc, **kw):
    common = dict(width=WIDTH, height=HEIGHT, tile_size=TILE,
                  pair_budget=kw.pop("pair_budget", 128 * 60),
                  max_tiles_per_gaussian=kw.pop("cover", 9))
    common.update(kw)
    fj = jax.jit(functools.partial(bin_j, **common))(
        *[jnp.asarray(a) for a in sc])
    ft = bin_t(*[torch.tensor(a) for a in sc], **common)
    return fj, ft


def _equal(fj, ft, names):
    for name in names:
        a, b = getattr(fj, name), getattr(ft, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("cover", [1, 4, 9])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("compact", [False, True])
def test_flat_bins_match_jax(cover, seed, compact):
    sc = _scene(seed)
    n = sc[0].shape[0]
    eb = None
    if compact:   # generous: nothing dropped by the expansion
        eb = ((n * cover + 127) // 128) * 128 - 128 if n * cover > 256 else 256
    fj, ft = _both(sc, cover=cover, expand_budget=eb)
    _equal(fj, ft, FIELDS)


@pytest.mark.parametrize("compact", [False, True])
def test_flat_bins_without_landing_match_jax(compact):
    sc = _scene(2)
    fj, ft = _both(sc, expand_budget=1280 if compact else None,
                   compute_landing=False)
    assert ft.landing is None
    _equal(fj, ft, FIELDS)


@pytest.mark.parametrize("compact", [False, True])
def test_flat_bins_local_tile_shard_match_jax(compact):
    sc = _scene(3)
    t_half = (-(-WIDTH // TILE) * -(-HEIGHT // TILE)) // 2
    fj, ft = _both(sc, expand_budget=1280 if compact else None, tile_lo=t_half,
                   num_tiles_local=t_half)
    names = [f for f in FIELDS if not (compact and f == "used")]
    _equal(fj, ft, names)


@pytest.mark.parametrize("layout", sorted(EDGE_LAYOUTS))
@pytest.mark.parametrize("compact", [False, True])
def test_flat_bins_edge_layouts_match_jax(layout, compact):
    """Empty tiles between occupied ones, no live Gaussian, and (compact)
    fewer live pairs than rows, so that the rows past them are used."""
    sc = EDGE_LAYOUTS[layout]()
    n = sc[0].shape[0]
    eb = 1280 if compact else None
    assert n * 9 > 1280   # the budget selects the compact enumeration
    if compact and layout == "few_live":
        assert int((sc[1] > 0).sum()) * 9 < eb
    fj, ft = _both(sc, expand_budget=eb)
    _equal(fj, ft, FIELDS)
    live_tiles = set(ft.blk_tile.numpy()[ft.blk_count.numpy() > 0].tolist())
    if layout == "empty_tiles_between":
        assert live_tiles == {0, 24, 59}
    if layout == "no_live_gaussian":
        assert not live_tiles and int(ft.used) == 0


@pytest.mark.parametrize("compact", [False, True])
def test_flat_bins_interior_tile_shard_match_jax(compact):
    """A local range in the middle of the frame: pairs fall outside it on
    both sides."""
    sc = _scene(10)
    lo, n_local = 20, 20
    full = bin_t(*[torch.tensor(a) for a in sc], width=WIDTH, height=HEIGHT,
                 tile_size=TILE, pair_budget=128 * 60,
                 max_tiles_per_gaussian=9)
    occupied = full.blk_tile.numpy()[full.blk_count.numpy() > 0]
    assert occupied.min() < lo and occupied.max() >= lo + n_local
    fj, ft = _both(sc, expand_budget=1280 if compact else None, tile_lo=lo,
                   num_tiles_local=n_local)
    names = [f for f in FIELDS if not (compact and f == "used")]
    _equal(fj, ft, names)


def test_binning_runs_no_scan():
    """The segment heads, aligned starts and compact row owners are read
    from per-tile and per-Gaussian arrays: no cummax / cummin runs, which
    the device runs in one CTA."""
    sc = [torch.tensor(a) for a in _scene(0)]
    geo = dict(width=WIDTH, height=HEIGHT, tile_size=TILE,
               max_tiles_per_gaussian=9)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for eb in (None, 1280):
            bin_t(*sc, pair_budget=128 * 60, expand_budget=eb, **geo)
        dense_t(*sc, tile_capacity=128, **geo)
    names = {e.name for e in prof.events()}
    assert "aten::sort" in names
    assert not [n for n in names if "cummax" in n or "cummin" in n]


def test_truncating_expand_budget_matches_jax():
    sc = _scene(4, cull_frac=0.0)
    fj, ft = _both(sc, expand_budget=256)
    _equal(fj, ft, FIELDS)
    assert int(ft.overflow) > 0
    gi = ft.gauss_ids.numpy()[ft.valid.numpy()]
    assert gi.min() >= 0 and gi.max() < sc[0].shape[0]


def test_small_budget_overflow_matches_jax():
    fj, ft = _both(_scene(5), pair_budget=128 * 8)
    _equal(fj, ft, FIELDS)
    assert int(ft.overflow) > 0


def test_auto_expand_budget_gate():
    eb = auto_expand_budget(441600, 196608, 9)
    assert eb is not None and eb % 128 == 0 and eb < 196608 * 9
    assert eb == -(-(441600 * 3 // 2) // 128) * 128
    assert auto_expand_budget(96000, 8192, 9) is None


def test_wide_cover_window_refused():
    assert cover_window(64) == 8
    with pytest.raises(ValueError):
        cover_window(81)


DENSE_FIELDS = ("indices", "mask", "landing", "overflow", "truncated",
                "trunc_by_win")


def _dense_both(sc, capacity, cover):
    """The dense layout by both frameworks, every field held equal."""
    common = dict(width=WIDTH, height=HEIGHT, tile_size=TILE,
                  tile_capacity=capacity, max_tiles_per_gaussian=cover)
    bj = jax.jit(functools.partial(dense_j, **common))(
        *[jnp.asarray(a) for a in sc])
    bt = dense_t(*[torch.tensor(a) for a in sc], **common)
    _equal(bj, bt, DENSE_FIELDS)
    return bt


@pytest.mark.parametrize("cover,capacity", [(1, 128), (4, 128), (9, 64),
                                            (16, 128), (100, 256)])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_bins_match_jax(cover, capacity, seed):
    """Window side 10 (cover 100) too: the dense layout packs no slots."""
    _dense_both(_scene(seed), capacity, cover)


def test_dense_bins_overflow_matches_jax():
    bt = _dense_both(_scene(6, n=600, cull_frac=0.1), 16, 9)
    assert int(bt.overflow) > 0
    # every kept pair lands in its slot, every dropped one nowhere
    land = bt.landing.numpy()
    kept = land[land >= 0]
    assert len(np.unique(kept)) == len(kept) == int(bt.mask.sum())


@pytest.mark.parametrize("layout", sorted(EDGE_LAYOUTS))
def test_dense_bins_edge_layouts_match_jax(layout):
    _dense_both(EDGE_LAYOUTS[layout](), 64, 9)
