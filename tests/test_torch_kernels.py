"""The port's CUDA kernels against their plain versions, and the wrappers'
routing. Imports no JAX, so the card's tests run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

The gpu-marked tests skip without a card (the card check is made inside a
fixture, never at import, so every test worker collects the same tests)."""
import numpy as np
import pytest
import torch

from flat_cases import B, CASES, T, TILES_X, TS, case, torch_fwd_bwd
from fusionsense_tpu_torch.kernels import build
from fusionsense_tpu_torch.render import flat_composite as FC


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def assert_columns_close(got, want, rel):
    """max |got - want| of each column within `rel` of the column's largest
    |want|: each gradient column is held at its own scale."""
    err = np.abs(got - want).max(axis=0)
    scale = np.abs(want).max(axis=0)
    assert np.all(err <= rel * scale), (err / np.maximum(scale, 1e-30)).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(card, name):
    tab, bt, _, bc, g_out, g_alpha = case(name)
    args = (tab, bt, bc, g_out, g_alpha)
    FC.reset_launch_counts()
    got = torch_fwd_bwd(*args, device=card)
    assert FC.LAUNCHES["flat_composite_fwd"] == 1
    assert FC.LAUNCHES["flat_composite_bwd"] == 1
    assert FC.LAUNCHES["flat_composite_fwd_plain"] == 0
    want = torch_fwd_bwd(*args, device="cpu")
    # K2 recovers T_excl by walking back from the block's exit log T, where
    # the plain version takes a forward cumsum, and sums over pixels in
    # another order. The saturated tile's wide Gaussians (sigma 12-20 px)
    # make the conic columns sums of large terms that cancel: there the two
    # differ by up to 9e-5 absolute, 5e-5 of the column's scale (H100), so
    # dtab is held both to 1e-4 absolute and to 1e-4 of each column's scale
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)
    assert_columns_close(got[2], want[2], 1e-4)


def test_cpu_tensors_take_the_plain_version():
    FC.reset_launch_counts()
    tab, bt, _, bc, g_out, g_alpha = case("mixed")
    torch_fwd_bwd(tab, bt, bc, g_out, g_alpha)
    assert FC.LAUNCHES == {"flat_composite_fwd": 0, "flat_composite_bwd": 0,
                           "flat_composite_fwd_plain": 1,
                           "flat_composite_bwd_plain": 1}


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrapper raises on what its kernel cannot take."""
    tab, bt, _, bc, _, _ = case("mixed")
    runs = FC.tile_runs(torch.tensor(bt), T)
    with pytest.raises(ValueError):
        FC.flat_composite_fwd_cuda(torch.tensor(tab), runs, torch.tensor(bc),
                                   T, TILES_X, TS, B)
    assert FC.LAUNCHES["flat_composite_fwd"] == 0


def test_build_is_keyed_by_source_and_lazy():
    """Importing the loader builds nothing; targets live under build/."""
    so = build._target("flat_composite")
    assert so.parent == build.BUILD_DIR and so.suffix == ".so"
    assert "build" in so.parts and so.name.startswith("flat_composite-")
    assert (build.CSRC / "flat_composite.cu").exists()
    assert build.load.cache_info().currsize == 0
