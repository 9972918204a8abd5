"""Kernels K3/K4 of the dense compositor: the port's plain version (CPU) and
composite2's autograd against pallas_composite2 in interpret mode, through
jax.vjp, on the random tile tables of flat_cases.py (the CUDA kernels are
held against the plain version in test_torch_kernels.py, on a card)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.render import pallas_composite2 as PC2
from fusionsense_tpu_torch.render import composite2 as C2

from flat_cases import (
    B, DENSE_CASES, DENSE_K, T, TILES_X, TS, dense_case, dense_stops,
    torch_dense_fwd_bwd,
)


def _jax_fwd_bwd(tab, counts, tile_ids, g_out, g_alpha):
    cj, tj = jnp.asarray(counts), jnp.asarray(tile_ids)
    f = lambda t: PC2.pallas_composite2(t, cj, tj, TILES_X, TS, B)  # noqa: E731
    (out, alpha), vjp = jax.vjp(f, jnp.asarray(tab))
    (dtab,) = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))
    return np.asarray(out), np.asarray(alpha), np.asarray(dtab)


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """Pallas's forward state (out (T, C, P), logT (T, P), carries, nused)
    and its (out, alpha, dtab) through jax.vjp, for one dense case; the
    tests of one file share a worker, so each case runs in interpret mode
    once."""
    tab, counts, tile_ids, g_out, g_alpha = dense_case(name)
    out, logt, carry, nused = PC2._run_fwd(
        jnp.asarray(tab), jnp.asarray(counts), jnp.asarray(tile_ids),
        tiles_x=TILES_X, tile_size=TS, B=B)
    state = (np.asarray(out), np.asarray(logt)[:, 0], np.asarray(carry),
             np.asarray(nused)[:, 0, 0])
    return state, _jax_fwd_bwd(tab, counts, tile_ids, g_out, g_alpha)


def _assert_state_matches(out, logt, carries, nused, name):
    """The plain forward state against Pallas's: nused exactly, out, log T,
    and the carries of the chunks composited; zero carries past nused."""
    out_j, logt_j, carry_j, nused_j = _pallas(name)[0]
    np.testing.assert_array_equal(nused, nused_j)
    np.testing.assert_allclose(out, out_j, atol=1e-5)
    np.testing.assert_allclose(logt, logt_j, atol=1e-4, rtol=1e-5)
    for t in range(T):
        n = nused_j[t]
        np.testing.assert_allclose(carries[t, :n], carry_j[t, :n], atol=1e-4,
                                   rtol=1e-5)
        assert np.all(carries[t, n:] == 0)


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_composite2_matches_pallas_forward_and_vjp(name):
    args = dense_case(name)
    out_j, alpha_j, dtab_j = _pallas(name)[1]
    out_t, alpha_t, dtab_t = torch_dense_fwd_bwd(*args)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(alpha_t, alpha_j, atol=1e-5)
    np.testing.assert_allclose(dtab_t, dtab_j, atol=1e-5, rtol=1e-4)
    assert np.nansum(np.abs(dtab_t)) > 0


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_plain_forward_state_matches_pallas(name):
    """log T, nused and the carries of the chunks composited, not only the
    outputs; the saturated tiles stop early and the empty tile composites
    nothing."""
    tab, counts, tile_ids, _, _ = dense_case(name)
    out_t, logt_t, carry_t, nused_t, _ = C2.composite2_fwd_plain(
        torch.tensor(tab), torch.tensor(counts), torch.tensor(tile_ids),
        TILES_X, TS, B)
    _assert_state_matches(out_t.numpy(), logt_t.numpy(), carry_t.numpy(),
                          nused_t.numpy(), name)
    nused = nused_t.numpy()
    spec = DENSE_CASES[name]
    chunks = -(-np.asarray(spec["counts"]) // B)
    for t, n in dense_stops(name).items():   # early termination
        assert nused[t] == n < chunks[t]
        assert logt_t.numpy()[t].max() <= C2.T_EPS_LOG
    empty = spec["counts"].index(0)
    assert nused[empty] == 0 and np.all(out_t.numpy()[empty] == 0)
    # a tile stops short of its chunks only once it is saturated, and some
    # tile composites a partly filled last chunk
    short = nused < chunks
    assert np.all(logt_t.numpy()[short].max(axis=1) <= C2.T_EPS_LOG)
    counts = np.asarray(spec["counts"])
    assert np.any((counts % B != 0) & (nused == chunks) & (counts > 0))


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_stage_twins_compose_to_pallas(name):
    """The plain stages, composed by hand (K3: chunks -> combine; K4:
    suffix -> chunks), against Pallas's forward state and VJP: out, log T,
    the carries and nused, then dtab; NaN where the reference has NaN."""
    tab, counts, tile_ids, g_out, g_alpha = dense_case(name)
    table, counts, tile_ids = (torch.tensor(a) for a in (tab, counts, tile_ids))
    delta, acc = C2.fwd_chunks_plain(table, counts, tile_ids, TILES_X, TS, B)
    out, logt, carries, nused = C2.fwd_combine_plain(delta, acc, counts, B)
    _assert_state_matches(out.numpy(), logt.numpy(), carries.numpy(),
                          nused.numpy(), name)
    # the chunk pass composites every chunk below ceil(count / B), the
    # ones past the stop too, and nothing else
    done = torch.arange(DENSE_K // B)[None, :] < C2.n_chunks(
        counts, B, DENSE_K // B)[:, None]
    assert torch.all(delta[~done] == 0) and torch.all(acc[~done] == 0)
    assert not (delta[done] == 0).all(dim=-1).any()
    g_out_t = torch.tensor(g_out).transpose(1, 2).contiguous()
    g_logt = -torch.tensor(g_alpha)
    S = C2.bwd_suffix_plain(acc, carries, nused, g_out_t)
    used = torch.arange(DENSE_K // B)[None, :] < nused[:, None].long()
    assert torch.all(S[~used] == 0)
    dtab = C2.bwd_chunks_plain(table, nused, tile_ids, g_out_t, g_logt, logt,
                               carries, S, TILES_X, TS, B)
    np.testing.assert_allclose(dtab.numpy(), _pallas(name)[1][2], atol=1e-5,
                               rtol=1e-4)


def test_dense_cases_do_what_they_name():
    """saturate_mid_tile: tile 0's chunk 2 is composited by the chunk pass
    only; nan_past_stop: the NaN in that chunk reaches nothing (tile 0's
    out, alpha and dtab are finite, chunk 2's dtab rows zero), the NaN in
    tile 3's composited chunk 1 reaches out and dtab."""
    for name in ("saturate_mid_tile", "nan_past_stop"):
        tab, counts, tile_ids, _, _ = dense_case(name)
        table, counts_t, ids = (torch.tensor(a) for a in (tab, counts, tile_ids))
        delta, acc = C2.fwd_chunks_plain(table, counts_t, ids, TILES_X, TS, B)
        nused = C2.fwd_combine_plain(delta, acc, counts_t, B)[3]
        assert nused[0] == 2 and counts[0] == DENSE_K
        # composited all the same: faint, or NaN from the NaN conic
        skipped = delta[0, 2]
        assert (skipped.max() < 0 if name == "saturate_mid_tile"
                else torch.isnan(skipped).all())
    tab, *_ = dense_case("nan_past_stop")
    assert np.isnan(tab[0, 2 * B:]).any() and np.isnan(tab[3, B]).any()
    out, alpha, dtab = torch_dense_fwd_bwd(*dense_case("nan_past_stop"))
    assert np.isfinite(out[0]).all() and np.isfinite(alpha[0]).all()
    assert np.isfinite(dtab[0]).all() and np.all(dtab[0, 2 * B:] == 0)
    assert np.abs(dtab[0, :2 * B]).sum() > 0
    assert np.isnan(out[3]).any() and np.isnan(dtab[3]).any()
    finite = [t for t in range(T) if t != 3]
    assert np.isfinite(out[finite]).all() and np.isfinite(dtab[finite]).all()


def test_offset_tile_ids_move_the_pixels():
    """The same rows composited as other tiles give another image: the
    wrapper really takes its pixels from tile_ids."""
    tab, counts, tile_ids, _, _ = dense_case("offset_slice")
    args = (torch.tensor(tab), torch.tensor(counts))
    out_a = C2.composite2_fwd_plain(*args, torch.tensor(tile_ids), TILES_X, TS,
                                    B)[0]
    out_b = C2.composite2_fwd_plain(*args, torch.tensor(tile_ids - 3), TILES_X,
                                    TS, B)[0]
    assert not torch.allclose(out_a, out_b, atol=1e-3)


def test_blend_bf16_raises():
    tab, counts, tile_ids, _, _ = dense_case("mixed")
    args = [torch.tensor(a) for a in (tab, counts, tile_ids)]
    with pytest.raises(NotImplementedError):
        C2.composite2(*args, TILES_X, TS, B, True)
    with pytest.raises(NotImplementedError):
        C2.composite2_fwd_plain(*args, TILES_X, TS, B, blend_bf16=True)
