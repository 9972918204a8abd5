"""Kernels K3/K4 of the dense compositor: the port's plain version (CPU) and
composite2's autograd against pallas_composite2 in interpret mode, through
jax.vjp, on the random tile tables of flat_cases.py (the CUDA kernels are
held against the plain version in test_torch_kernels.py, on a card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.render import pallas_composite2 as PC2
from fusionsense_tpu_torch.render import composite2 as C2

from flat_cases import (
    B, DENSE_CASES, T, TILES_X, TS, dense_case, torch_dense_fwd_bwd,
)


def _jax_fwd_bwd(tab, counts, tile_ids, g_out, g_alpha):
    cj, tj = jnp.asarray(counts), jnp.asarray(tile_ids)
    f = lambda t: PC2.pallas_composite2(t, cj, tj, TILES_X, TS, B)  # noqa: E731
    (out, alpha), vjp = jax.vjp(f, jnp.asarray(tab))
    (dtab,) = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))
    return np.asarray(out), np.asarray(alpha), np.asarray(dtab)


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_composite2_matches_pallas_forward_and_vjp(name):
    args = dense_case(name)
    out_j, alpha_j, dtab_j = _jax_fwd_bwd(*args)
    out_t, alpha_t, dtab_t = torch_dense_fwd_bwd(*args)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(alpha_t, alpha_j, atol=1e-5)
    np.testing.assert_allclose(dtab_t, dtab_j, atol=1e-5, rtol=1e-4)
    assert np.abs(dtab_t).sum() > 0


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_plain_forward_state_matches_pallas(name):
    """log T, nused and the carries of the chunks composited, not only the
    outputs; the saturated tile stops early and the empty tile composites
    nothing."""
    tab, counts, tile_ids, _, _ = dense_case(name)
    out_j, logt_j, carry_j, nused_j = PC2._run_fwd(
        jnp.asarray(tab), jnp.asarray(counts), jnp.asarray(tile_ids),
        tiles_x=TILES_X, tile_size=TS, B=B)
    out_t, logt_t, carry_t, nused_t = C2.composite2_fwd_plain(
        torch.tensor(tab), torch.tensor(counts), torch.tensor(tile_ids),
        TILES_X, TS, B)
    nused = np.asarray(nused_j)[:, 0, 0]
    np.testing.assert_array_equal(nused_t.numpy(), nused)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(logt_t.numpy(), np.asarray(logt_j)[:, 0],
                               atol=1e-4, rtol=1e-5)
    carry_j = np.asarray(carry_j)
    for t in range(T):
        n = nused[t]
        np.testing.assert_allclose(carry_t.numpy()[t, :n], carry_j[t, :n],
                                   atol=1e-4, rtol=1e-5)
        assert np.all(carry_t.numpy()[t, n:] == 0)
    spec = DENSE_CASES[name]
    chunks = -(-np.asarray(spec["counts"]) // B)
    sat = spec["saturate"][0]
    assert nused[sat] < chunks[sat]          # early termination
    assert logt_t.numpy()[sat].max() <= C2.T_EPS_LOG
    empty = spec["counts"].index(0)
    assert nused[empty] == 0 and np.all(out_t.numpy()[empty] == 0)
    # a tile stops short of its chunks only once it is saturated, and some
    # tile composites a partly filled last chunk
    short = nused < chunks
    assert np.all(logt_t.numpy()[short].max(axis=1) <= C2.T_EPS_LOG)
    counts = np.asarray(spec["counts"])
    assert np.any((counts % B != 0) & (nused == chunks) & (counts > 0))


def test_offset_tile_ids_move_the_pixels():
    """The same rows composited as other tiles give another image: the
    wrapper really takes its pixels from tile_ids."""
    tab, counts, tile_ids, _, _ = dense_case("offset_slice")
    args = (torch.tensor(tab), torch.tensor(counts))
    out_a, _, _, _ = C2.composite2_fwd_plain(*args, torch.tensor(tile_ids),
                                             TILES_X, TS, B)
    out_b, _, _, _ = C2.composite2_fwd_plain(*args, torch.tensor(tile_ids - 3),
                                             TILES_X, TS, B)
    assert not torch.allclose(out_a, out_b, atol=1e-3)


def test_blend_bf16_raises():
    tab, counts, tile_ids, _, _ = dense_case("mixed")
    args = [torch.tensor(a) for a in (tab, counts, tile_ids)]
    with pytest.raises(NotImplementedError):
        C2.composite2(*args, TILES_X, TS, B, True)
    with pytest.raises(NotImplementedError):
        C2.composite2_fwd_plain(*args, TILES_X, TS, B, blend_bf16=True)
