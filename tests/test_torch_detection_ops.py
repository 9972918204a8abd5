"""The port's detection ops (fusionsense_tpu_torch/ops/detection.py) against
the JAX package's, on the CPU, on seeded numpy inputs: every function at
atol 1e-5, and nms / ml_nms's index lists exactly. The port's maps are
channel-first, (C, H, W), where JAX's are (H, W, C)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.ops import detection as J
from fusionsense_tpu_torch.ops import detection as T

TOL = dict(atol=1e-5, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _chw(a):
    return _t(np.transpose(a, (2, 0, 1)))


def _boxes(rng, n, size=40.0, min_wh=2.0, max_wh=16.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_iou():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 30), _boxes(rng, 20)
    b[0] = [5, 5, 5, 9]                      # zero area
    np.testing.assert_allclose(T.box_iou(_t(a), _t(b)).numpy(),
                               np.asarray(J.box_iou(a, b)), **TOL)


@pytest.mark.parametrize("n,max_out,thr", [(60, 100, 0.5), (60, 10, 0.3),
                                           (1, 5, 0.5), (40, 40, 0.0)])
def test_nms_keeps_the_same_boxes(n, max_out, thr):
    rng = np.random.default_rng(n + max_out)
    boxes = _boxes(rng, n, size=30.0)
    scores = rng.uniform(size=n).astype(np.float32)
    scores[::7] = scores[0]                  # ties: the first index wins
    scores[1::9] = -np.inf                   # never kept
    keep, valid = T.nms(_t(boxes), _t(scores), thr, max_out=max_out)
    jk, jv = J.nms(boxes, scores, thr, max_out=max_out)
    assert keep.dtype == torch.int32 and keep.shape == (max_out,)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


def test_ml_nms_keeps_the_same_boxes():
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 80, size=30.0)
    scores = rng.uniform(size=80).astype(np.float32)
    scores[40:] = 0.0                        # zero rows, as the postprocess has
    labels = rng.integers(1, 4, 80).astype(np.int32)
    keep, valid = T.ml_nms(_t(boxes), _t(scores), _t(labels), 0.6, max_out=50)
    jk, jv = J.ml_nms(boxes, scores, labels, 0.6, max_out=50)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms(method):
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, 25, size=20.0)
    scores = rng.uniform(size=25).astype(np.float32)
    np.testing.assert_allclose(
        T.soft_nms(_t(boxes), _t(scores), method=method).numpy(),
        np.asarray(J.soft_nms(boxes, scores, method=method)), **TOL)


def test_roi_align():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(17, 23, 5)).astype(np.float32)
    boxes = np.array([[2.0, 3.0, 10.5, 12.0], [0.0, 0.0, 22.0, 16.0],
                      [15.2, 1.0, 15.4, 1.1], [-3.0, 4.0, 8.0, 30.0]],
                     np.float32)
    got = T.roi_align(_chw(f), _t(boxes), output_size=4, spatial_scale=0.9,
                      sampling_ratio=2)
    want = np.asarray(J.roi_align(f, boxes, output_size=4, spatial_scale=0.9,
                                  sampling_ratio=2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_roi_pool():
    rng = np.random.default_rng(3)
    f = rng.normal(size=(12, 14, 3)).astype(np.float32)
    boxes = np.array([[0.0, 0.0, 3.0, 3.0], [2.4, 1.6, 11.0, 9.0],
                      [5.0, 5.0, 5.0, 5.0], [10.0, 8.0, 20.0, 30.0]],
                     np.float32)
    got = T.roi_pool(_chw(f), _t(boxes), output_size=3)
    want = np.asarray(J.roi_pool(f, boxes, output_size=3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_deform_roi_pool():
    rng = np.random.default_rng(4)
    f = rng.normal(size=(16, 16, 3)).astype(np.float32)
    boxes = np.array([[2.0, 3.0, 10.0, 12.0], [0.0, 1.0, 15.0, 14.0]],
                     np.float32)
    off = rng.normal(size=(2, 4, 4, 2)).astype(np.float32)
    got = T.deform_roi_pool(_chw(f), _t(boxes), _t(off), output_size=4,
                            spatial_scale=1.1, sampling_ratio=2, gamma=0.3)
    want = np.asarray(J.deform_roi_pool(f, boxes, off, output_size=4,
                                        spatial_scale=1.1, sampling_ratio=2,
                                        gamma=0.3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_sigmoid_focal_loss():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(50, 7)) * 4).astype(np.float32)
    targets = (rng.uniform(size=(50, 7)) > 0.7).astype(np.float32)
    np.testing.assert_allclose(
        T.sigmoid_focal_loss(_t(logits), _t(targets), 0.3, 1.5).numpy(),
        np.asarray(J.sigmoid_focal_loss(logits, targets, 0.3, 1.5)), **TOL)


def test_bilinear_sample_zero_outside():
    rng = np.random.default_rng(7)
    img = rng.normal(size=(9, 11, 4)).astype(np.float32)
    py = rng.uniform(-2, 11, (5, 6)).astype(np.float32)
    px = rng.uniform(-2, 13, (5, 6)).astype(np.float32)
    got = T._bilinear_sample(_chw(img), _t(py), _t(px))
    want = np.asarray(J._bilinear_sample(jnp.asarray(img), py, px))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, **TOL)


@pytest.mark.parametrize("stride,dilation,dg,modulated", [
    (1, 1, 1, True), (2, 1, 1, True), (1, 2, 2, False), (2, 1, 2, True)])
def test_deform_conv2d(stride, dilation, dg, modulated):
    rng = np.random.default_rng(stride * 10 + dilation + dg)
    H, W, Cin, Cout = 13, 10, 4, 6
    x = rng.normal(size=(H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, Cin, Cout)) * 0.3).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    Ho = (H + 2 - dilation * 2 - 1) // stride + 1
    Wo = (W + 2 - dilation * 2 - 1) // stride + 1
    # offsets large enough that taps leave the map
    off = (rng.normal(size=(Ho, Wo, dg * 18)) * 2.5).astype(np.float32)
    mask = (rng.uniform(size=(Ho, Wo, dg * 9)).astype(np.float32)
            if modulated else None)
    want = np.asarray(J.deform_conv2d(
        x, off, w, b, mask=mask, stride=stride, padding=1, dilation=dilation,
        deformable_groups=dg))
    got = T.deform_conv2d(
        _chw(x), _chw(off), _t(np.transpose(w, (3, 2, 0, 1))), _t(b),
        mask=None if mask is None else _chw(mask), stride=stride, padding=1,
        dilation=dilation, deformable_groups=dg)
    assert got.shape == (Cout, Ho, Wo)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, **TOL)
