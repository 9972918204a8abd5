"""Active Touch Selection on the card against the same code on the CPU (no
JAX: the card's machine has none).

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_touch.py

The full-width GLIP detector (Swin-L, BERT-base, the 8-tower VLDyHead) on
one 320x320 view with seeded random weights, run with TF32 off
(priors/tf32.py) while both global flags allow it; the z-buffer's index map
and depth, exactly; nms / ml_nms's index lists, exactly, with no host sync
inside. They skip without a card.
"""
import numpy as np
import pytest
import torch

from fusionsense_tpu_torch.detection import GLIPModel, GLIPPredictor
from fusionsense_tpu_torch.detection.convert import random_state_dict
from fusionsense_tpu_torch.detection.model import preprocess_image
from fusionsense_tpu_torch.detection.tokenizer import WordPieceTokenizer
from fusionsense_tpu_torch.ops.detection import ml_nms, nms
from fusionsense_tpu_torch.touch_select import partseg as P

# card against CPU, each output's largest |d| over its largest |value|
# (chip_smoke.py's limit: the H100 read at most 3.4e-4 at 320x320)
GLIP_REL = 1e-3
PARTS = ["handle", "lid", "spout"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


@pytest.fixture
def tf32_default():
    b, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = b.allow_tf32, mm.allow_tf32
    b.allow_tf32 = mm.allow_tf32 = True
    yield
    b.allow_tf32, mm.allow_tf32 = old


def _predictors(card):
    sd = random_state_dict(GLIPModel(), seed=0)
    out = []
    for dev in ("cpu", card):
        net = GLIPModel()
        net.load_state_dict(sd)
        tok = WordPieceTokenizer.toy([" . ".join(PARTS)], max_len=256)
        out.append(GLIPPredictor(net, tok, min_size=320,
                                 confidence_threshold=0.02, device=dev))
    return out


@pytest.mark.gpu
def test_full_width_glip_card_matches_cpu(card, tf32_default):
    cpu, gpu = _predictors(card)
    rgb = (np.random.default_rng(0).uniform(size=(320, 320, 3)) * 255).astype(
        np.uint8)
    image, _ = preprocess_image(rgb, 320)
    enc = cpu.encode(PARTS)
    (_, _, _, _), want = cpu.run(image, *enc)
    (_, _, _, _), got = gpu.run(image, *enc)
    for lv, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("bbox", "ctr", "dot"), g, w):
            a = a.cpu()
            assert torch.isfinite(a).all()
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
            assert err <= GLIP_REL, (lv, name, err)
    dg, dc = gpu.detect(rgb, PARTS), cpu.detect(rgb, PARTS)
    assert len(dg.labels) > 0 and dg.labels == dc.labels
    np.testing.assert_allclose(dg.boxes, dc.boxes, atol=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [96, 400])
def test_zbuffer_render_card_matches_cpu(card, size):
    rng = np.random.RandomState(0)
    pts = (rng.randn(50_000, 3) * 0.3).astype(np.float32)
    pts = np.concatenate([pts, pts[:5000]])            # exact depth ties
    cols = rng.rand(len(pts), 3).astype(np.float32)
    for m in P.fixed_viewpoints(4).astype(np.float32):
        args = [torch.from_numpy(a) for a in (pts, cols, m)]
        want = P._zbuffer_render(*args, 0.9 * size / 2, size=size)
        got = P._zbuffer_render(*(a.to(card) for a in args), 0.9 * size / 2,
                                size=size)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_nms_on_the_card_equals_cpu_without_a_host_sync(card):
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 300, (3000, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 60, (3000, 2))], 1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(size=3000).astype(np.float32))
    scores[::5] = 0.0
    labels = torch.from_numpy(rng.integers(1, 4, 3000).astype(np.int32))
    want = (nms(boxes, scores, 0.6), ml_nms(boxes, scores, labels, 0.6))
    b, s, l = boxes.to(card), scores.to(card), labels.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = (nms(b, s, 0.6), ml_nms(b, s, l, 0.6))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (gk, gv), (wk, wv) in zip(got, want):
        assert torch.equal(gk.cpu(), wk) and torch.equal(gv.cpu(), wv)
