"""The port's GLIP detector (fusionsense_tpu_torch/detection) against the
JAX package's flax modules, on the CPU at small widths.

One seeded random torch state dict goes into each port module and,
through the JAX package's convert_state_dict, into its flax twin; the
port's state_dict_from_flax must give the state dict back exactly.
Modules (Swin with shifted windows and padding, BERT with a padded mask,
FPN, VLFuse, one DyConv with coarser levels reading reinterpreted offsets)
at atol 1e-4 / rtol 1e-3; the whole tiny GLIPModel on a 64x64 image at
1e-3 / 1e-3; the postprocess of JAX's head outputs through both packages:
equal labels, boxes within 1e-3 px, scores within 1e-5 on the valid rows.
The flax tiny model is applied through one jit (module fixture).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.detection import anchors as JAn
from fusionsense_tpu.detection import bert as JB
from fusionsense_tpu.detection import convert as JC
from fusionsense_tpu.detection import fpn as JF
from fusionsense_tpu.detection import fusion as JU
from fusionsense_tpu.detection import head as JH
from fusionsense_tpu.detection import model as JM
from fusionsense_tpu.detection import postprocess as JP
from fusionsense_tpu.detection import swin as JS
from fusionsense_tpu.detection import tokenizer as JT
from fusionsense_tpu_torch.detection import anchors as TAn
from fusionsense_tpu_torch.detection import bert as TB
from fusionsense_tpu_torch.detection import convert as TC
from fusionsense_tpu_torch.detection import fpn as TF
from fusionsense_tpu_torch.detection import fusion as TU
from fusionsense_tpu_torch.detection import head as TH
from fusionsense_tpu_torch.detection import model as TM
from fusionsense_tpu_torch.detection import postprocess as TP
from fusionsense_tpu_torch.detection import swin as TS
from fusionsense_tpu_torch.detection import tokenizer as TT
from fusionsense_tpu_torch.priors import weights as W

MODULE_TOL = dict(atol=1e-4, rtol=1e-3)
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _chw(a):
    return _t(np.transpose(np.asarray(a), (2, 0, 1)))


def _hwc(t):
    return t.detach().permute(1, 2, 0).numpy()


def _seeded(net, seed, prefix=""):
    """The port's seeded GLIP state dict for `net`, loaded into it, with
    its keys under `prefix` (the GLIP model's path of the module)."""
    sd = TC.random_state_dict(net, seed=seed)
    net.load_state_dict(sd)
    net.eval()
    return {prefix + k: v for k, v in sd.items()}


def _flax(state, depths=(1, 1, 1, 1), num_convs=1, bert_layers=1):
    return JC.convert_state_dict(_np(state), depths=depths,
                                 num_convs=num_convs, bert_layers=bert_layers)


# ------------------------------------------------------------- modules ----

def test_swin_shifted_windows_with_padding():
    """Depth 2 per stage (a shifted block in each), a 52x44 image: neither
    side divides the window at any stage."""
    jcfg = JS.SwinConfig(embed_dim=8, depths=(2, 2, 2, 2),
                         num_heads=(1, 2, 2, 2), window=4)
    net = TS.SwinTransformer(TS.SwinConfig(
        embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 2), window=4))
    params = _flax(_seeded(net, 1, "backbone.body."), depths=jcfg.depths)
    img = np.random.default_rng(1).normal(size=(52, 44, 3)).astype(np.float32)
    want = jax.jit(JS.SwinTransformer(jcfg).apply)(
        {"params": params["backbone"]}, img)
    with torch.no_grad():
        got = net(_chw(img))
    assert [tuple(g.shape) for g in got] == [(16, 7, 6), (32, 4, 3),
                                              (64, 2, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_hwc(g), np.asarray(w), **MODULE_TOL)


def test_bert_encoder_with_padded_mask():
    jcfg = JB.BertConfig(vocab_size=50, hidden=32, layers=2, heads=2,
                         intermediate=64, max_positions=32)
    net = TB.BertEncoder(TB.BertConfig(vocab_size=50, hidden=32, layers=2,
                                       heads=2, intermediate=64,
                                       max_positions=32))
    params = _flax(_seeded(net, 2, "language_backbone.body.model."),
                   bert_layers=2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, 16)
    mask = np.r_[np.ones(9), np.zeros(7)].astype(np.int64)
    want = jax.jit(JB.BertEncoder(jcfg).apply)(
        {"params": params["language_backbone"]}, ids.astype(np.int32),
        mask.astype(np.int32))
    with torch.no_grad():
        got = net(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("sizes", [((8, 8), (4, 4), (2, 2)),
                                   ((7, 6), (4, 3), (2, 2))])
def test_fpn(sizes):
    """Sizes that do not divide exercise the repeat-then-crop upsample."""
    chans = (16, 32, 64)
    net = TF.FPN(chans, 32)
    params = _flax(_seeded(net, 3, "backbone.fpn."))
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(h, w, c)).astype(np.float32)
             for (h, w), c in zip(sizes, chans)]
    want = jax.jit(JF.FPN(32).apply)({"params": params["fpn"]}, feats)
    with torch.no_grad():
        got = net([_chw(f) for f in feats])
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(_hwc(g), np.asarray(w), **MODULE_TOL)


def test_upsample_nearest_is_repeat_then_crop():
    x = np.arange(12, dtype=np.float32).reshape(3, 4, 1)
    got = TF._upsample_nearest(_chw(x), 7, 9)
    np.testing.assert_array_equal(_hwc(got), np.asarray(
        JF._upsample_nearest(jnp.asarray(x), 7, 9)))


LEVELS = ((8, 7), (4, 4), (2, 2), (1, 1), (1, 1))


def _levels(rng, c):
    return [rng.normal(size=(h, w, c)).astype(np.float32) for h, w in LEVELS]


def test_vlfuse():
    net = TU.VLFuse(32, 24, 64)
    params = _flax(_seeded(net, 4, "rpn.head.dyhead_tower.0."))
    rng = np.random.default_rng(4)
    feats = _levels(rng, 32)
    lang = rng.normal(size=(10, 24)).astype(np.float32)
    mask = np.r_[np.ones(6), np.zeros(4)].astype(np.int32)
    jnet = JU.VLFuse(32, 24, 64)
    want_v, want_l = jax.jit(jnet.apply)(
        {"params": params["head"]["fuse_0"]}, feats, lang, mask)
    with torch.no_grad():
        got_v, got_l = net([_chw(f) for f in feats], _t(lang), _t(mask))
    for g, w in zip(got_v, want_v):
        np.testing.assert_allclose(_hwc(g), np.asarray(w), **MODULE_TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **MODULE_TOL)


def test_dyconv_reads_reinterpreted_offsets():
    """Each level's offsets drive the coarser level's conv through the
    row-major prefix of each plane (8x7 read as 4x4, 4x4 as 2x2, ...)."""
    net = TH.DyConv(32)
    params = _flax(_seeded(net, 5, "rpn.head.dyhead_tower.2."))
    # offsets of a few pixels, so the taps really move
    rng = np.random.default_rng(5)
    feats = _levels(rng, 32)
    want = jax.jit(JH.DyConv(32).apply)(
        {"params": params["head"]["dyconv_0"]}, feats)
    with torch.no_grad():
        got = net([_chw(f) for f in feats])
        om = net.offset(_chw(feats[0]))
    assert float(om[:18].abs().max()) > 1.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(_hwc(g), np.asarray(w), **MODULE_TOL)
    t = np.arange(3 * 8 * 7, dtype=np.float32).reshape(3, 8, 7)
    np.testing.assert_array_equal(
        TH._reinterpret_plane(_t(t), 4, 4).numpy(),
        t.reshape(3, -1)[:, :16].reshape(3, 4, 4))


def test_upsample_bilinear_align_corners():
    x = np.random.default_rng(6).normal(size=(3, 4, 2)).astype(np.float32)
    got = TH._upsample_bilinear_ac(_chw(x), 7, 9)
    np.testing.assert_allclose(_hwc(got), np.asarray(
        JH._upsample_bilinear_ac(jnp.asarray(x), 7, 9)), atol=1e-6)
    one = TH._upsample_bilinear_ac(_chw(x[:1, :1]), 2, 2)
    np.testing.assert_array_equal(_hwc(one), np.broadcast_to(x[:1, :1],
                                                             (2, 2, 2)))


# -------------------------------------------------------- whole model ----

@pytest.fixture(scope="module")
def tiny():
    """(port model, its state dict, flax params, jitted flax apply)."""
    cfg, jcfg = TM.tiny_config(), JM.tiny_config()
    net = TM.GLIPModel(cfg)
    sd = _seeded(net, 0)
    params = _flax(sd, depths=jcfg.swin.depths, num_convs=jcfg.num_convs,
                   bert_layers=jcfg.bert.layers)
    apply = jax.jit(JM.GLIPModel(jcfg).apply)
    return net, sd, params, apply


def _inputs(cfg, seed=0, n_valid=20):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(64, 64, 3)).astype(np.float32)
    T = cfg.max_query_len
    ids = rng.integers(0, cfg.bert.vocab_size, T)
    mask = (np.arange(T) < n_valid).astype(np.int64)
    return img, ids, mask


def test_rule_table_is_the_published_key_set(tiny):
    net, sd, params, _ = tiny
    cfg = net.cfg
    rules = TC.rules(cfg)
    assert set(net.state_dict()) == set(rules)
    jrules = JC.build_rules(depths=cfg.swin.depths, num_convs=cfg.num_convs,
                            bert_layers=cfg.bert.layers)
    assert {k: v[0] for k, v in rules.items()} == {
        k: v[0] for k, v in jrules.items()}
    full = TC.rules()
    assert set(full) == set(JC.expected_torch_keys())
    assert set(full) == set(W.shapes_of(lambda: TM.GLIPModel()))


def test_state_dict_from_flax_round_trip(tiny):
    net, sd, params, _ = tiny
    back = TC.state_dict_from_flax(params, net.cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k


def test_load_glip_checkpoint_unwraps_and_is_strict(tiny, tmp_path):
    net, sd, _, _ = tiny
    extra = {"rpn.head.cls_logits.weight": torch.zeros(3),
             "backbone.body.layers.0.blocks.0.attn.relative_position_index":
                 torch.zeros(4, dtype=torch.int64)}
    wrapped = {"model": {"module." + k: v for k, v in {**sd, **extra}.items()}}
    torch.save(wrapped, tmp_path / "glip.pth")
    got = TC.load_glip_checkpoint(str(tmp_path / "glip.pth"), net.cfg)
    assert not got.training
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del wrapped["model"]["module.rpn.head.bias0"]
    torch.save(wrapped, tmp_path / "short.pth")
    with pytest.raises(RuntimeError):
        TC.load_glip_checkpoint(str(tmp_path / "short.pth"), net.cfg)


def test_glip_model_matches_flax(tiny):
    net, _, params, apply = tiny
    img, ids, mask = _inputs(net.cfg)
    want = apply({"params": params}, img, ids.astype(np.int32),
                 mask.astype(np.int32))
    with torch.no_grad():
        got = net(_chw(img), _t(ids), _t(mask))
    assert len(got) == len(want) == 5
    for lv, ((gb, gc, gd), (wb, wc, wd)) in enumerate(zip(got, want)):
        n = LEVEL_N[lv]
        assert gb.shape == (n, 4) and gc.shape == (n,) and gd.shape == (
            n, net.cfg.max_query_len)
        for g, w in ((gb, wb), (gc, wc), (gd, wd)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"level {lv}", **MODEL_TOL)


LEVEL_N = [64, 16, 4, 1, 1]


def test_postprocess_of_the_same_head_outputs(tiny):
    """JAX's head outputs through both postprocesses: most class scores sit
    below the threshold (exact zeros), so the top-k order among ties
    decides which zero rows reach ml_nms's class offsets."""
    net, _, params, apply = tiny
    img, ids, mask = _inputs(net.cfg, seed=1)
    outs = apply({"params": params}, img, ids.astype(np.int32),
                 mask.astype(np.int32))
    pm = np.zeros((3, net.cfg.max_query_len), np.float32)
    for j, (a, b) in enumerate(((1, 3), (4, 5), (6, 9))):
        pm[j, a:b] = 1.0 / (b - a)
    hw = (64, 64)
    anchors = JAn.pyramid_anchors(JM._level_shapes(hw))
    want = JP.postprocess(outs, [jnp.asarray(a) for a in anchors],
                          jnp.asarray(pm), hw)
    got = TP.postprocess(
        [tuple(_t(np.asarray(x)) for x in o) for o in outs],
        [_t(a) for a in anchors], _t(pm), hw)
    wb, ws, wl, wv = (np.asarray(x) for x in want)
    gb, gs, gl, gv = (x.numpy() for x in got)
    cls = np.concatenate([np.asarray(JP.scores_from_token_logits(d, pm))
                          for _, _, d in outs])
    assert (cls <= JP.PRE_NMS_THRESH).mean() > 0.5    # zero rows present
    assert 0 < wv.sum()
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gl[wv], wl[wv])
    np.testing.assert_allclose(gb[wv], wb[wv], atol=1e-3, rtol=0)
    np.testing.assert_allclose(gs[wv], ws[wv], atol=1e-5, rtol=0)


def test_select_level_top_k_among_ties():
    """Equal scores come out lowest index first, as lax.top_k gives them."""
    rng = np.random.default_rng(7)
    n, T = 40, 6
    dot = np.full((n, T), -20.0, np.float32)
    dot[[3, 17, 30]] = 3.0
    pm = np.eye(2, T, dtype=np.float32)
    bbox = rng.normal(size=(n, 4)).astype(np.float32)
    ctr = np.zeros(n, np.float32)
    anc = TAn.level_anchors(5, 8, 8, 64)
    want = JP.select_level(dot, bbox, ctr, anc, pm, top_n=20)
    got = TP.select_level(_t(dot), _t(bbox), _t(ctr), _t(anc), _t(pm),
                          top_n=20)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


# ----------------------------------------------------------- predictor ----

def test_tokenizer_caption_and_positive_map():
    names = ["teapot handle", "lid", "spout"]
    caption, spans = TM.build_caption(names)
    assert (caption, spans) == JM.build_caption(names)
    tok, jtok = TT.WordPieceTokenizer.toy([caption], 24), \
        JT.WordPieceTokenizer.toy([caption], 24)
    assert tok.vocab == jtok.vocab
    enc, jenc = tok.encode(caption), jtok.encode(caption)
    assert (enc.ids, enc.mask, enc.offsets) == (jenc.ids, jenc.mask,
                                                jenc.offsets)
    np.testing.assert_array_equal(
        TM.positive_map_from_spans(enc, spans, 24),
        JM.positive_map_from_spans(jenc, spans, 24))


def test_anchors_and_decode():
    shapes = JM._level_shapes((100, 70))
    assert shapes == TM._level_shapes((100, 70))
    for a, b in zip(TAn.pyramid_anchors(shapes), JAn.pyramid_anchors(shapes)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(8)
    preds = (rng.normal(size=(30, 4)) * 8).astype(np.float32)
    anc = TAn.level_anchors(5, 6, 16, 128)
    np.testing.assert_allclose(
        TP.decode_boxes(_t(preds), _t(anc)).numpy(),
        np.asarray(JP.decode_boxes(preds, anc)), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("hw,min_size", [((48, 64), 64), ((40, 40), 40),
                                         ((30, 90), 50)])
def test_preprocess_image(hw, min_size):
    rgb = (np.random.default_rng(9).uniform(size=(*hw, 3)) * 255).astype(
        np.uint8)
    got, scale = TM.preprocess_image(rgb, min_size, max_size=120)
    want, jscale = JM.preprocess_image(rgb, min_size, max_size=120)
    assert scale == jscale and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_predictor_detect_matches_jax(tiny):
    """GLIPPredictor.detect on the CPU against the JAX predictor's own
    steps (preprocess, caption, the same jitted model, postprocess,
    threshold, rescale) on a 64x64 view."""
    net, _, params, apply = tiny
    cfg = net.cfg
    names = ["handle", "lid"]
    caption = JM.build_caption(names)[0]
    tok = TT.WordPieceTokenizer.toy([caption], max_len=cfg.max_query_len)
    jtok = JT.WordPieceTokenizer.toy([caption], max_len=cfg.max_query_len)
    rgb = (np.random.default_rng(10).uniform(size=(64, 64, 3)) * 255).astype(
        np.uint8)
    pred = TM.GLIPPredictor(net, tok, min_size=64, confidence_threshold=0.0,
                            device="cpu")
    det = pred.detect(rgb, names)

    image, scale = JM.preprocess_image(rgb, 64)
    cap, spans = JM.build_caption(names)
    enc = jtok.encode(cap)
    pm = JM.positive_map_from_spans(enc, spans, len(enc.ids))
    outs = apply({"params": params}, image, np.asarray(enc.ids, np.int32),
                 np.asarray(enc.mask, np.int32))
    anchors = [jnp.asarray(a) for a in JAn.pyramid_anchors(
        JM._level_shapes(image.shape[:2]))]
    boxes, scores, labels, valid = (np.asarray(x) for x in JP.postprocess(
        outs, anchors, jnp.asarray(pm), image.shape[:2]))
    keep = valid & (scores > 0.0)
    assert keep.sum() > 0
    assert det.labels == [int(l) - 1 for l in labels[keep]]
    np.testing.assert_allclose(det.boxes, boxes[keep] / scale, atol=1e-3)
    np.testing.assert_allclose(det.scores, scores[keep], atol=1e-5)
