"""Kernels K1/K2 of the flat compositor: the port's plain version (CPU)
against pallas_flat.flat_composite in interpret mode, on the random tables
and block maps of flat_cases.py (the CUDA kernels are held against the plain
version in test_torch_kernels.py, on a card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.render import pallas_flat
from fusionsense_tpu_torch.render import flat_composite as FC

from flat_cases import B, CASES, T, TILES_X, TS, case, maps, torch_fwd_bwd


def _jax_fwd_bwd(tab, blk_tile, blk_first, blk_count, g_out, g_alpha):
    args = [jnp.asarray(a) for a in (blk_tile, blk_first, blk_count, blk_tile)]
    f = lambda t: pallas_flat.flat_composite(t, *args, T, TILES_X, TS, B)  # noqa: E731
    (out, alpha), vjp = jax.vjp(f, jnp.asarray(tab))
    (dtab,) = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))
    return np.asarray(out), np.asarray(alpha), np.asarray(dtab)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_forward_and_vjp(name):
    tab, bt, bf, bc, g_out, g_alpha = case(name)
    out_j, alpha_j, dtab_j = _jax_fwd_bwd(tab, bt, bf, bc, g_out, g_alpha)
    out_t, alpha_t, dtab_t = torch_fwd_bwd(tab, bt, bc, g_out, g_alpha)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(alpha_t, alpha_j, atol=1e-5)
    np.testing.assert_allclose(dtab_t, dtab_j, atol=1e-5, rtol=1e-4)
    assert np.abs(dtab_t).sum() > 0


def test_plain_forward_state_matches_pallas():
    """log T and the per-block carries, not only the masked outputs; the
    saturated tile really skips blocks; the empty tile gives zeros."""
    tab, bt, bf, bc, _, _ = case("mixed")
    out_j, logt_j, carry_j = pallas_flat._run_fwd(
        jnp.asarray(tab), jnp.asarray(bt), jnp.asarray(bf), jnp.asarray(bc),
        jnp.asarray(bt), T, tiles_x=TILES_X, tile_size=TS, B=B)
    runs = FC.tile_runs(torch.tensor(bt), T)
    out_t, logt_t, carry_t = FC.flat_composite_fwd_plain(
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


def test_blend_bf16_raises():
    tab, bt, _, bc, _, _ = case("mixed")
    blk = [torch.tensor(a) for a in (bt, bc)]
    with pytest.raises(NotImplementedError):
        FC.flat_composite(torch.tensor(tab), *blk, T, TILES_X, TS, B, True)
    runs = FC.tile_runs(blk[0], T)
    with pytest.raises(NotImplementedError):
        FC.flat_composite_fwd_plain(torch.tensor(tab), runs, blk[1], T,
                                    TILES_X, TS, B, blend_bf16=True)


def test_tile_runs_cover_every_block():
    bt, _, _ = maps([2, 1, 0, 3, 4, 1])
    runs = FC.tile_runs(torch.tensor(bt), T).numpy()
    assert runs[0] == 0 and runs[-1] == len(bt)
    for t in range(T + 1):
        assert np.all(bt[runs[t]:runs[t + 1]] == t)
