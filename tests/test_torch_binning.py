"""The port's bin_gaussians (dense) and flat_bin_gaussians against the JAX
reference, exactly.

Scenes are built so every live Gaussian has a unique 16-bit depth rank half
a quantum away from the rank boundaries (ROADMAP F1: the reference's
sort_key_val leaves the order of equal ranks unspecified, and a 1-ulp log
difference between frameworks must not move a rank). The cases are those
of tests/test_binning_compact.py: dense and compact enumerations, with and
without the landing map, a local tile shard and a truncating expand budget. The dense layout is held on
the same scenes at several cover windows and tile capacities, one of which
overflows. Flat windows stay at 8 or less (F2); `used` is not compared in
compact plus tile-local mode (F3).
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
    # unique ranks among the live Gaussians, endpoints included, each half
    # a quantum from its boundaries
    live = np.nonzero(radius > 0)[0]
    nq = 65535
    ranks = np.concatenate([[0, nq], rng.choice(np.arange(1, nq - 1),
                                                len(live) - 2, replace=False)])
    rng.shuffle(ranks)
    frac = np.where((ranks > 0) & (ranks < nq), ranks + 0.5, ranks) / nq
    lo, hi = np.log(0.5), np.log(6.0)
    depth = rng.uniform(0.5, 6.0, n)
    depth[live] = np.exp(lo + frac * (hi - lo))
    return mean2d, radius, depth.astype(np.float32)


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


@pytest.mark.parametrize("cover,capacity", [(1, 128), (4, 128), (9, 64),
                                            (16, 128), (100, 256)])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_bins_match_jax(cover, capacity, seed):
    """Window side 10 (cover 100) too: the dense layout packs no slots."""
    sc = _scene(seed)
    common = dict(width=WIDTH, height=HEIGHT, tile_size=TILE,
                  tile_capacity=capacity, max_tiles_per_gaussian=cover)
    bj = jax.jit(functools.partial(dense_j, **common))(
        *[jnp.asarray(a) for a in sc])
    bt = dense_t(*[torch.tensor(a) for a in sc], **common)
    _equal(bj, bt, DENSE_FIELDS)


def test_dense_bins_overflow_matches_jax():
    sc = _scene(6, n=600, cull_frac=0.1)
    common = dict(width=WIDTH, height=HEIGHT, tile_size=TILE,
                  tile_capacity=16, max_tiles_per_gaussian=9)
    bj = jax.jit(functools.partial(dense_j, **common))(
        *[jnp.asarray(a) for a in sc])
    bt = dense_t(*[torch.tensor(a) for a in sc], **common)
    _equal(bj, bt, DENSE_FIELDS)
    assert int(bt.overflow) > 0
    # every kept pair lands in its slot, every dropped one nowhere
    land = bt.landing.numpy()
    kept = land[land >= 0]
    assert len(np.unique(kept)) == len(kept) == int(bt.mask.sum())
