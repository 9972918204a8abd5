"""Kernels K1/K2 of the flat compositor: the port's plain version (CPU)
against pallas_flat.flat_composite in interpret mode, on the random tables
and block maps of flat_cases.py (the CUDA kernels are held against the plain
version in test_torch_kernels.py, on a card)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.render import pallas_flat
from fusionsense_tpu_torch.render import flat_composite as FC
from fusionsense_tpu_torch.render.flat_composite import (
    _alpha_of_rows, _pixel_xy,
)

from flat_cases import (
    B, C, CASES, P, T, TILES_X, TS, assert_bf16_rounds, case, maps,
    shard_case, torch_fwd_bwd,
)


def _jax_fwd_bwd(tab, blk_tile, blk_first, blk_count, g_out, g_alpha,
                 blend_bf16=False, num_tiles=T, tile_lo=0):
    """pallas_flat.flat_composite and its VJP; blk_gtile = blk_tile +
    tile_lo, as the sharded step passes it."""
    args = [jnp.asarray(a) for a in (blk_tile, blk_first, blk_count,
                                     blk_tile + tile_lo)]
    f = lambda t: pallas_flat.flat_composite(  # noqa: E731
        t, *args, num_tiles, TILES_X, TS, B, blend_bf16)
    (out, alpha), vjp = jax.vjp(f, jnp.asarray(tab))
    (dtab,) = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))
    return np.asarray(out), np.asarray(alpha), np.asarray(dtab)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU ops on one thread for this module's tests. With the
    intra-op pool, torch.exp of the same inputs came out up to 3.3e-6
    apart between two calls in one process (a block's alpha up to 1e-4,
    out up to 5.4e-5 apart) in some processes, and the culled_rows
    case failed its 1e-5 limit in about one run in five; on one thread
    every run gave the usual result. The JAX reference did not vary."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_forward_and_vjp(name):
    tab, bt, bf, bc, g_out, g_alpha = case(name)
    out_j, alpha_j, dtab_j = _jax_fwd_bwd(tab, bt, bf, bc, g_out, g_alpha)
    out_t, alpha_t, dtab_t = torch_fwd_bwd(tab, bt, bc, g_out, g_alpha)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(alpha_t, alpha_j, atol=1e-5)
    np.testing.assert_allclose(dtab_t, dtab_j, atol=1e-5, rtol=1e-4)
    assert np.nansum(np.abs(dtab_t)) > 0


def test_plain_forward_state_matches_pallas():
    """log T and the per-block carries, not only the masked outputs; the
    saturated tile really skips blocks; the empty tile gives zeros."""
    tab, bt, bf, bc, _, _ = case("mixed")
    out_j, logt_j, carry_j = pallas_flat._run_fwd(
        jnp.asarray(tab), jnp.asarray(bt), jnp.asarray(bf), jnp.asarray(bc),
        jnp.asarray(bt), T, tiles_x=TILES_X, tile_size=TS, B=B)
    runs = FC.tile_runs(torch.tensor(bt), T)
    out_t, logt_t, carry_t, _, _ = FC.flat_composite_fwd_plain(
        torch.tensor(tab), runs, torch.tensor(bc), T, TILES_X, TS, B)
    owned = np.isin(np.arange(T + 1), bt)
    np.testing.assert_allclose(out_t.numpy()[owned], np.asarray(out_j)[owned],
                               atol=1e-5)
    np.testing.assert_allclose(logt_t.numpy()[owned],
                               np.asarray(logt_j)[owned, 0], atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(carry_t.numpy(), np.asarray(carry_j)[:, 0],
                               atol=1e-4, rtol=1e-5)
    # tile 2 owns no block: zero output, alpha 0
    assert not owned[2]
    assert np.all(out_t.numpy()[2] == 0) and np.all(logt_t.numpy()[2] == 0)
    # tile 4 saturates in its first block, so its later carries stay there
    sat_blocks = np.nonzero(bt == 4)[0]
    assert carry_t.numpy()[sat_blocks[1]].max() <= FC.T_EPS_LOG
    np.testing.assert_array_equal(carry_t.numpy()[sat_blocks[1:]],
                                  carry_t.numpy()[sat_blocks[1:2]].repeat(
                                      len(sat_blocks) - 1, 0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_twins_compose_to_pallas(name):
    """The plain stages, composed by hand (K1: blocks -> scan -> combine;
    K2: suffix -> blocks), against Pallas's forward state and VJP: log T,
    the carries and out, then dtab; NaN where the reference has NaN."""
    tab, bt, bf, bc, g_out, g_alpha = case(name)
    out_j, logt_j, carry_j = pallas_flat._run_fwd(
        jnp.asarray(tab), jnp.asarray(bt), jnp.asarray(bf), jnp.asarray(bc),
        jnp.asarray(bt), T, tiles_x=TILES_X, tile_size=TS, B=B)
    _, _, dtab_j = _jax_fwd_bwd(tab, bt, bf, bc, g_out, g_alpha)
    table, count = torch.tensor(tab), torch.tensor(bc)
    runs = FC.tile_runs(torch.tensor(bt), T)
    delta, acc, _, _ = FC.fwd_blocks_plain(table, runs, count, TILES_X, TS, B)
    carry, live, logt = FC.fwd_scan_plain(delta, runs, count)
    out = FC.fwd_combine_plain(acc, carry, live, runs)
    owned = np.isin(np.arange(T + 1), bt)
    np.testing.assert_allclose(out.numpy()[owned], np.asarray(out_j)[owned],
                               atol=1e-5)
    np.testing.assert_allclose(logt.numpy()[owned],
                               np.asarray(logt_j)[owned, 0], atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(carry.numpy(), np.asarray(carry_j)[:, 0],
                               atol=1e-4, rtol=1e-5)
    g_out_t = torch.zeros((T + 1, P, C))
    g_out_t[:T] = torch.tensor(g_out)
    g_logt = torch.zeros((T + 1, P))
    g_logt[:T] = -torch.tensor(g_alpha)
    g_out_t = g_out_t.transpose(1, 2).contiguous()
    S = FC.bwd_suffix_plain(acc, carry, live, runs, g_out_t)
    dtab = FC.bwd_blocks_plain(table, runs, live, g_out_t, g_logt, logt,
                               carry, S, TILES_X, TS, B)
    np.testing.assert_allclose(dtab.numpy(), dtab_j, atol=1e-5, rtol=1e-4)


def test_cases_do_what_they_name():
    """long_run: all 14 blocks of tile 1 live; saturate_mid_run: tile 1
    saturates in its block 4 and the carries freeze; culled_rows: the
    NaN-conic row reaches out and dtab."""
    def state(name):
        tab, bt, _, bc, g_out, g_alpha = case(name)
        runs = FC.tile_runs(torch.tensor(bt), T)
        _, _, carry, _, live = FC.flat_composite_fwd_plain(
            torch.tensor(tab), runs, torch.tensor(bc), T, TILES_X, TS, B)
        return bt, carry.max(dim=1).values.numpy(), live.numpy(), (
            tab, bt, bc, g_out, g_alpha)

    bt, _, live, _ = state("long_run")
    assert (bt == 1).sum() == 14 and live[bt == 1].all()
    bt, cmax, live, _ = state("saturate_mid_run")
    run = np.nonzero(bt == 1)[0]
    assert live[run[:5]].all() and not live[run[5:]].any()
    assert cmax[run[4]] > FC.T_EPS_LOG >= cmax[run[5]]
    np.testing.assert_array_equal(cmax[run[5:]], cmax[run[5]])
    _, _, _, args = state("culled_rows")
    out, alpha, dtab = torch_fwd_bwd(*args)
    tab, bt = args[0], args[1]
    nan_row = np.nonzero(bt == 2)[0][1] * B
    assert np.isnan(out[2]).all() and np.isnan(alpha[2]).all()
    assert np.isfinite(out[[0, 1, 3, 4, 5]]).all()
    assert np.isnan(dtab[nan_row]).any() and np.isnan(tab[nan_row]).any()


def test_cull_marks_only_rows_of_zero_alpha():
    """Every culled row gives alpha = 0 and alive = False at every pixel of
    its tile; dead-slot and padding rows are culled, the NaN row, live rows
    and rows near the cull's bounds are not."""
    tab, bt, _, bc, _, _ = case("culled_rows")
    runs = FC.tile_runs(torch.tensor(bt), T)
    tile = FC.block_tiles(runs, len(bt))
    table = torch.tensor(tab)
    cull = FC.cull_rows(table, tile, TILES_X, TS, B)
    rows = table.reshape(len(bt), B, -1)
    px, py = _pixel_xy(tile, TILES_X, TS, P)
    alpha, alive, _ = _alpha_of_rows(rows, px, py)
    assert not alpha[cull].any() and not alive[cull].any()
    dead = rows[..., 5] <= math.log(1e-12) + 1e-3
    finite = torch.isfinite(rows).all(dim=-1)
    assert torch.equal(cull, dead & finite)
    assert int((dead & ~finite).sum()) == 1
    # near the bounds: log_op -14; an indefinite conic; a PSD conic whose
    # quadratic form over the tile reaches ~1e6
    row = torch.tensor([[8.0, 8.0, 0.25, 0.0, 0.25, -20.0, 0, 0] + [0.5] * C])
    edge = row.repeat(B, 1)
    edge[1, 5] = -14.0
    edge[2, 3] = 0.3
    edge[3, 2:5] = torch.tensor([1e4, 0.0, 1e4])
    got = FC.cull_rows(edge, torch.zeros(1, dtype=torch.long), TILES_X, TS, B)
    assert got[0, 0] and not got[0, 1:4].any()
    # fwd_blocks reports the rows it keeps: B less the culled ones, in the
    # blocks it composites
    _, _, kept, _ = FC.fwd_blocks_plain(table, runs, torch.tensor(bc), TILES_X,
                                     TS, B)
    want = np.where(bc > 0, B - cull.sum(dim=1).numpy(), 0)
    np.testing.assert_array_equal(kept.numpy(), want)
    assert kept.dtype == torch.int32 and (kept[torch.tensor(bc) > 0] < B).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bf16_matches_pallas_forward_and_vjp(name):
    """blend_bf16 at the limits flat_cases.py states, alpha as in float32,
    beside the float32 blend."""
    tab, bt, bf, bc, g_out, g_alpha = case(name)
    out_j, alpha_j, dtab_j = _jax_fwd_bwd(tab, bt, bf, bc, g_out, g_alpha,
                                          blend_bf16=True)
    out_t, alpha_t, dtab_t = torch_fwd_bwd(tab, bt, bc, g_out, g_alpha,
                                           blend_bf16=True)
    out_f, _, dtab_f = torch_fwd_bwd(tab, bt, bc, g_out, g_alpha)
    np.testing.assert_allclose(alpha_t, alpha_j, atol=1e-5)
    assert_bf16_rounds(out_t, dtab_t, out_f, dtab_f, out_j, dtab_j)


def test_tile_runs_cover_every_block():
    bt, _, _ = maps([2, 1, 0, 3, 4, 1])
    runs = FC.tile_runs(torch.tensor(bt), T).numpy()
    assert runs[0] == 0 and runs[-1] == len(bt)
    for t in range(T + 1):
        assert np.all(bt[runs[t]:runs[t + 1]] == t)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_at_tile_lo_matches_pallas_blk_gtile(name, n):
    """A tile-sharded mesh's blocks: each shard's local layout at tile_lo =
    me * T_loc against pallas_flat at blk_gtile = blk_tile + tile_lo; the
    shards' outputs, concatenated, are the unsharded ones, their dtab rows
    the unsharded rows of the same blocks, and fwd_blocks keeps the rows
    the global tile's cull keeps (n = 4 pads 6 tiles to 8: the last shard
    owns none)."""
    tab, bt, _, bc, g_out, g_alpha = case(name)
    out_f, alpha_f, dtab_f = torch_fwd_bwd(tab, bt, bc, g_out, g_alpha)
    runs_f = FC.tile_runs(torch.tensor(bt), T)
    _, _, kept_f, _ = FC.fwd_blocks_plain(torch.tensor(tab), runs_f,
                                          torch.tensor(bc), TILES_X, TS, B)
    outs, alphas = [], []
    for me in range(n):
        tab_l, bt_l, bf_l, bc_l, g_o, g_a, lo, t_loc, blocks = shard_case(
            name, n, me)
        out_t, alpha_t, dtab_t = torch_fwd_bwd(tab_l, bt_l, bc_l, g_o, g_a,
                                               num_tiles=t_loc, tile_lo=lo)
        out_j, alpha_j, dtab_j = _jax_fwd_bwd(tab_l, bt_l, bf_l, bc_l, g_o,
                                              g_a, num_tiles=t_loc,
                                              tile_lo=lo)
        np.testing.assert_allclose(out_t, out_j, atol=1e-5)
        np.testing.assert_allclose(alpha_t, alpha_j, atol=1e-5)
        np.testing.assert_allclose(dtab_t, dtab_j, atol=1e-5, rtol=1e-4)
        rows = slice(blocks.start * B, blocks.stop * B)
        np.testing.assert_array_equal(dtab_t[:rows.stop - rows.start],
                                      dtab_f[rows])
        runs = FC.tile_runs(torch.tensor(bt_l), t_loc)
        _, _, kept, _ = FC.fwd_blocks_plain(torch.tensor(tab_l), runs,
                                            torch.tensor(bc_l), TILES_X, TS,
                                            B, tile_lo=lo)
        np.testing.assert_array_equal(
            kept.numpy()[:blocks.stop - blocks.start], kept_f.numpy()[blocks])
        outs.append(out_t)
        alphas.append(alpha_t)
    np.testing.assert_array_equal(np.concatenate(outs)[:T], out_f)
    np.testing.assert_array_equal(np.concatenate(alphas)[:T], alpha_f)
    assert np.all(np.concatenate(outs)[T:] == 0)


def test_tile_lo_moves_pixels_and_cull():
    """tile_lo is not a no-op: the same local layout at another global tile
    composites other pixels; and a faint row with a narrow footprint at
    the centre of global tile 0 is culled at tile 0 (its quadratic form
    stays under the bound there) but not when its block is global tile 4."""
    tab_l, bt_l, _, bc_l, g_o, g_a, lo, t_loc, _ = shard_case("mixed", 2, 1)
    at = torch_fwd_bwd(tab_l, bt_l, bc_l, g_o, g_a, num_tiles=t_loc,
                       tile_lo=lo)
    off = torch_fwd_bwd(tab_l, bt_l, bc_l, g_o, g_a, num_tiles=t_loc)
    assert np.abs(at[0] - off[0]).max() > 1e-2
    row = torch.tensor([[8.0, 8.0, 1e3, 0.0, 1e3, -20.0, 0, 0] + [0.5] * C])
    local0 = torch.zeros(1, dtype=torch.long)
    assert FC.cull_rows(row.repeat(B, 1), local0, TILES_X, TS, B).all()
    assert not FC.cull_rows(row.repeat(B, 1), local0, TILES_X, TS, B,
                            tile_lo=4).any()
