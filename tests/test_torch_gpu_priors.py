"""The prior nets and the resampler on the card against the same code on
the CPU, at the tiny configs (no JAX: the card's machine has none).

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_priors.py

Each predictor runs its net with TF32 off in cuDNN's convolutions and in
CUDA matmuls (priors/tf32.py), so with both global flags allowing TF32 the
card must still agree with the CPU at float32 limits; these tests hold that
choice. They skip without a card.
"""
import numpy as np
import pytest
import torch

from fusionsense_tpu_torch.priors import weights as W
from fusionsense_tpu_torch.priors.depth_anything import (
    DepthAnything, DepthAnythingModel, tiny_da,
)
from fusionsense_tpu_torch.priors.dsine import DSINE, DSinePredictor
from fusionsense_tpu_torch.priors.dsine.model import tiny_dsine
from fusionsense_tpu_torch.priors.metric3d import (
    Metric3D, Metric3DPredictor, tiny_m3d,
)
from fusionsense_tpu_torch.priors.resize import resize

NORMAL_ATOL = 1e-4     # unit normals
DEPTH_RTOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


@pytest.fixture
def tf32_default():
    """TF32 allowed for the test in cuDNN's convolutions (PyTorch's
    default) and in CUDA matmuls (as set_float32_matmul_precision("high")
    allows it)."""
    b, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = b.allow_tf32, mm.allow_tf32
    b.allow_tf32 = mm.allow_tf32 = True
    yield
    b.allow_tf32, mm.allow_tf32 = old


def _rgb(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)


def _twins(make_net, wrap, seed):
    net = make_net()
    sd = W.random_state_dict(net, seed=seed)
    if "depth_head.scratch.output_conv2.2.bias" in sd:   # keep depth > 0
        sd["depth_head.scratch.output_conv2.0.bias"] += 0.5
        sd["depth_head.scratch.output_conv2.2.bias"] += 0.5
    out = []
    for dev in ("cpu", "cuda"):
        n = make_net()
        n.load_state_dict(sd)
        out.append(wrap(n, dev))
    return out


@pytest.mark.gpu
def test_dsine_card_matches_cpu(card, tf32_default):
    cpu, gpu = _twins(lambda: DSINE(tiny_dsine()),
                      lambda n, d: DSinePredictor(n, device=d), 0)
    rgb = _rgb(0)
    np.testing.assert_allclose(gpu.predict_normals(rgb),
                               cpu.predict_normals(rgb), atol=NORMAL_ATOL)


@pytest.mark.gpu
def test_metric3d_card_matches_cpu(card, tf32_default):
    cpu, gpu = _twins(lambda: Metric3D(tiny_m3d()),
                      lambda n, d: Metric3DPredictor(n, (56, 98), device=d), 1)
    rgb = _rgb(1)
    np.testing.assert_allclose(gpu.predict_depth(rgb, 60.0),
                               cpu.predict_depth(rgb, 60.0), rtol=DEPTH_RTOL)
    np.testing.assert_allclose(gpu.predict_normals(rgb),
                               cpu.predict_normals(rgb), atol=NORMAL_ATOL)


@pytest.mark.gpu
def test_depth_anything_card_matches_cpu(card, tf32_default):
    cpu, gpu = _twins(lambda: DepthAnything(tiny_da()),
                      lambda n, d: DepthAnythingModel(n, lower=56, device=d), 2)
    rgb = _rgb(2)
    np.testing.assert_allclose(gpu.predict_inverse(rgb),
                               cpu.predict_inverse(rgb), rtol=DEPTH_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape,out", [((48, 64, 3), (518, 686, 3)),
                                       ((100, 80, 3), (33, 27, 3))])
def test_resize_card_matches_cpu(card, shape, out, method):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(
        np.float32))
    got = resize(x.to(card), out, method).cpu()
    torch.testing.assert_close(got, resize(x, out, method), atol=1e-5,
                               rtol=1e-5)
