"""The port's prior nets (DSINE, Depth-Anything-V2, Metric3D) against the
JAX package's flax nets, on the CPU at their tiny configs.

One seeded random torch state dict goes into the port's net and, through
the JAX package's convert_state_dict, into the flax net; the encoder
features, the full forward and each predictor's pre/post path are
compared, and the port's state_dict_from_flax must give the state dict
back exactly. Forward tolerances are those of the JAX package's parity
tests for the same nets, or tighter: DSINE's encoder rtol/atol 2e-4
(tests/test_parity_dsine.py), Depth-Anything rtol 1e-4 / atol 1e-6
(test_parity_depth_anything.py), Metric3D in float64 at rtol 1e-8 / atol
1e-9 (test_parity_metric3d.py). The JAX side runs jitted.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.priors.depth_anything import convert as JAC
from fusionsense_tpu.priors.depth_anything import predictor as JAP
from fusionsense_tpu.priors.depth_anything import vit as JAV
from fusionsense_tpu.priors.dsine import convert as JDC
from fusionsense_tpu.priors.dsine import efficientnet as JDE
from fusionsense_tpu.priors.dsine import model as JD
from fusionsense_tpu.priors.dsine import predictor as JDP
from fusionsense_tpu.priors.metric3d import convert as JMC
from fusionsense_tpu.priors.metric3d import model as JM
from fusionsense_tpu.priors.metric3d import predictor as JMP
from fusionsense_tpu_torch.priors.depth_anything import convert as TAC
from fusionsense_tpu_torch.priors.depth_anything import predictor as TAP
from fusionsense_tpu_torch.priors.dsine import convert as TDC
from fusionsense_tpu_torch.priors.dsine import model as TD
from fusionsense_tpu_torch.priors.dsine import predictor as TDP
from fusionsense_tpu_torch.priors.metric3d import convert as TMC
from fusionsense_tpu_torch.priors.metric3d import model as TM
from fusionsense_tpu_torch.priors.metric3d import predictor as TMP

from prior_cases import build

DSINE_TOL = dict(rtol=2e-4, atol=2e-4)
DA_TOL = dict(rtol=1e-4, atol=1e-6)
M3D_TOL64 = dict(rtol=1e-8, atol=1e-9)
NETS = ("dsine", "da", "m3d")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def nets():
    return {n: build(n) for n in NETS}


RULES = {"dsine": TDC.build_rules, "da": TAC.rules, "m3d": TMC.rules}
FROM_FLAX = {"dsine": TDC.state_dict_from_flax, "da": TAC.state_dict_from_flax,
             "m3d": TMC.state_dict_from_flax}


@pytest.mark.parametrize("name", NETS)
def test_state_dict_keys_are_the_rule_table(nets, name):
    """The port's parameter names are the published checkpoint keys the
    JAX converter reads: the port's rule table, equal to the JAX one."""
    net, _, _, cfg, jcfg = nets[name]
    rules = RULES[name](cfg)
    assert set(net.state_dict()) == set(rules)
    jrules = {"dsine": JDC.build_rules, "da": JAC.rules,
              "m3d": JMC.rules}[name](jcfg)
    assert {k: v[0] for k, v in rules.items()} == {
        k: v[0] for k, v in jrules.items()}


@pytest.mark.parametrize("name", NETS)
def test_state_dict_from_flax_round_trip(nets, name):
    _, sd, params, cfg, _ = nets[name]
    back = FROM_FLAX[name](params, cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k


def _hwc(x):
    return np.transpose(np.asarray(x), (1, 2, 0))


def _nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None]


def test_dsine_encoder_features_match_flax(nets):
    net, _, params, _, jcfg = nets["dsine"]
    img = np.random.default_rng(3).normal(size=(64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        got = net.encoder(_nchw(img))
    want = jax.jit(JDE.EfficientNetEncoder(jcfg.effnet).apply)(
        {"params": params["encoder"]}, img)
    for k in want:
        np.testing.assert_allclose(_hwc(got[k][0]), np.asarray(want[k]),
                                   err_msg=k, **DSINE_TOL)


def test_dsine_forward_and_predictor_match_flax(nets):
    """The full forward (off-centre principal point, so the uv grids and
    the refinement's geometry are exercised) and DSinePredictor's pad /
    FOV intrinsics / crop path on a frame that is not a multiple of 32."""
    net, _, params, _, jcfg = nets["dsine"]
    rng = np.random.default_rng(4)
    H, Wd = 64, 96
    img = rng.normal(size=(H, Wd, 3)).astype(np.float32)
    K = np.array([[70.0, 0, Wd / 2 - 0.3], [0, 72.0, H / 2 + 0.2], [0, 0, 1]],
                 np.float32)
    jp = JDP.DSinePredictor(params, jcfg)
    with torch.no_grad():
        got = net(_nchw(img), torch.from_numpy(K)[None])[0]
    want = np.asarray(jp._run(params, jnp.asarray(img), jnp.asarray(K)))
    np.testing.assert_allclose(_hwc(got), want, **DSINE_TOL)
    np.testing.assert_allclose(np.linalg.norm(want, axis=-1), 1.0, atol=1e-5)

    rgb = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
    tp = TDP.DSinePredictor(net, device="cpu")
    got = tp.predict_normals(rgb)
    assert got.shape == (40, 56, 3)
    np.testing.assert_allclose(got, jp.predict_normals(rgb), **DSINE_TOL)


def test_da_encoder_forward_and_predictor_match_flax(nets):
    """A grid that is not the native one (the bicubic pos-embed resample),
    the full forward, and the predictor's resize up to the 14-multiple
    input, inverse depth back down, and lstsq alignment to sensor depth."""
    net, _, params, _, jcfg = nets["da"]
    rng = np.random.default_rng(5)
    img = rng.normal(size=(98, 84, 3)).astype(np.float32)   # 7 x 6 patches
    with torch.no_grad():
        feats = net.pretrained(_nchw(img))
        got = net(_nchw(img))[0].numpy()
    jfeats = jax.jit(JAV.DinoViT(jcfg.vit).apply)(
        {"params": params["pretrained"]}, img)
    for (p, c), (pj, cj) in zip(feats, jfeats):
        np.testing.assert_allclose(_hwc(p[0]), np.asarray(pj), **DA_TOL)
        np.testing.assert_allclose(c[0].numpy(), np.asarray(cj), **DA_TOL)
    jm = JAP.DepthAnythingModel(params, jcfg, lower=56)
    want = np.asarray(jm._fwd(params, jnp.asarray(img)))
    assert want.min() > 0
    np.testing.assert_allclose(got, want, **DA_TOL)

    rgb = (rng.uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    tm = TAP.DepthAnythingModel(net, lower=56, device="cpu")
    np.testing.assert_allclose(tm.predict_inverse(rgb), jm.predict_inverse(rgb),
                               **DA_TOL)
    got = tm.predict_depth(rgb, 50.0)
    assert got.dtype == np.float32 and got.shape == (48, 64)
    np.testing.assert_allclose(got, jm.predict_depth(rgb, 50.0), rtol=1e-4)
    # aligned to sensor depth (every third row missing): the port's fit of
    # its own depth. The float32 normal equations of both packages cancel
    # on the random net's nearly constant depth (it varies by 0.3%), where
    # their summation orders alone move the fit by a few percent, so the
    # fit is held to JAX's on well-posed data in test_torch_priors.py
    from fusionsense_tpu_torch.priors.depth_align import scale_and_shift_lstsq

    sensor = (2.0 * got + 0.3).astype(np.float32)
    sensor[::3] = 0.0
    aligned = tm.predict_depth(rgb, 50.0, sensor_depth=sensor)
    d, sn = torch.from_numpy(got), torch.from_numpy(sensor)
    s, t = scale_and_shift_lstsq(d, sn, sn > 1e-6)
    np.testing.assert_array_equal(aligned, (s * d + t).numpy())


def test_m3d_forward_float64_matches_flax(nets):
    """Float64 on both sides, as the JAX package's Metric3D parity test
    runs, on a grid that is not the native one (4 x 6 patches)."""
    net, _, params, _, jcfg = nets["m3d"]
    img = np.random.default_rng(6).normal(size=(56, 84, 3))
    net64 = TM.Metric3D(net.cfg).double()
    net64.load_state_dict(net.state_dict())
    with torch.no_grad():
        feats = net64.encoder(_nchw(img))
        d, n, k = net64(_nchw(img))
    with x64():
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        jfeats = jax.jit(JM.RegisterViT(jcfg).apply)(
            {"params": p64["encoder"]}, img)
        dj, nj, kj = jax.jit(JM.Metric3D(jcfg).apply)({"params": p64}, img)
        jfeats, dj, nj, kj = jax.tree.map(np.asarray, (jfeats, dj, nj, kj))
    for f, fj in zip(feats, jfeats):
        np.testing.assert_allclose(_hwc(f[0]), fj, **M3D_TOL64)
    np.testing.assert_allclose(d[0].numpy(), dj, **M3D_TOL64)
    np.testing.assert_allclose(_hwc(n[0]), nj, **M3D_TOL64)
    np.testing.assert_allclose(k[0].numpy(), kj, **M3D_TOL64)


def test_m3d_predictor_matches_jax(nets):
    """Metric3DPredictor's canvas, un-pad, de-canonicalisation and clamp
    (depth) and its normals at the capture's resolution, in float32."""
    net, _, params, _, jcfg = nets["m3d"]
    rgb = (np.random.default_rng(7).uniform(size=(48, 64, 3)) * 255).astype(
        np.uint8)
    size = (56, 98)
    tp = TMP.Metric3DPredictor(net, input_size=size, device="cpu")
    jp = JMP.Metric3DPredictor(params=params, cfg=jcfg, input_size=size)
    got, want = tp.predict_depth(rgb, 60.0), jp.predict_depth(rgb, 60.0)
    assert got.shape == (48, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got, want = tp.predict_normals(rgb), jp.predict_normals(rgb)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def _save_wrapped(path, name, sd):
    """A checkpoint file wrapped as each JAX converter unwraps it."""
    if name == "dsine":
        obj = {"model": {f"module.{k}": v for k, v in sd.items()}}
    elif name == "da":
        obj = {"state_dict": dict(sd, **{"pretrained.mask_token":
                                         torch.zeros(1, 32)})}
    else:
        obj = {"model_state_dict": {f"depth_model.{k}": v
                                    for k, v in sd.items()}}
    torch.save(obj, path)


LOADERS = {"dsine": TDC.load_dsine_checkpoint, "da": TAC.load_da_checkpoint,
           "m3d": TMC.load_metric3d_checkpoint}


@pytest.mark.parametrize("name", NETS)
def test_load_checkpoint_unwraps_and_is_strict(nets, name, tmp_path):
    _, sd, _, cfg, _ = nets[name]
    path = tmp_path / "ckpt.pt"
    _save_wrapped(path, name, sd)
    loaded = LOADERS[name](str(path), cfg)
    assert not loaded.training
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # a key the net needs and the file lacks raises
    short = dict(sd)
    short.pop(next(iter(short)))
    _save_wrapped(path, name, short)
    with pytest.raises(RuntimeError):
        LOADERS[name](str(path), cfg)


def test_refinement_pieces_match_jax():
    """DSINE's replicate-padded patch unfold (neighbour order dy * ps + dx),
    convex upsampling and axis_angle_to_matrix near angle 0."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 7, 3)).astype(np.float32)
    got = TD.unfold_patches(_nchw(x), 5)[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(JD._unfold_patches(x, 5)))
    mask = rng.normal(size=(6, 7, 9 * 16)).astype(np.float32)
    got = TD.convex_upsample(_nchw(x), _nchw(mask), 4)[0]
    np.testing.assert_allclose(_hwc(got), np.asarray(
        JD.convex_upsample(x, mask, 4)), rtol=1e-6, atol=1e-6)
    aa = np.concatenate([rng.normal(size=(8, 3)), 1e-8 * rng.normal(size=(4, 3)),
                         np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_allclose(
        TD.axis_angle_to_matrix(torch.from_numpy(aa)).numpy(),
        np.asarray(JD.axis_angle_to_matrix(aa)), atol=1e-6)


def test_m3d_pipeline_generate_matches_jax(nets, tmp_path):
    """Metric3DPredictor.pipeline().generate (the reference's file writer:
    uint16 depth PNGs at 1000 per metre under d_ names, normal
    visualisations) on the predictor's canvas, against the same files made
    from JAX's predictor (whose own pipeline() feeds its net the 720x1280
    canvas it cannot take, ROADMAP F8): each pixel within one unit (a
    float32 rounding may cross a quantisation step)."""
    from PIL import Image

    from fusionsense_tpu.priors.metric3d import wrapper as WJ

    net, _, params, _, jcfg = nets["m3d"]
    size = (56, 98)
    root = tmp_path / "capture"
    (root / "images").mkdir(parents=True)
    rgb = (np.random.default_rng(9).uniform(size=(48, 64, 3)) * 255).astype(
        np.uint8)
    Image.fromarray(rgb).save(root / "images" / "c_00000.png")
    d, n = TMP.Metric3DPredictor(net, size, device="cpu").pipeline().generate(
        root, tmp_path / "t", fx=60.0)
    got = [np.asarray(Image.open(p), np.int64)
           for p in (d / "d_00000.png", n / "c_00000.png")]
    jp = JMP.Metric3DPredictor(params=params, cfg=jcfg, input_size=size)
    inp, pad, _ = WJ.prepare_input(rgb, 60.0, size)
    normal = WJ.postprocess_normal(jp.predict_canonical(inp)[1], pad)
    want = [(1000.0 * jp.predict_depth(rgb, 60.0)).astype(np.uint16),
            ((normal + 1.0) / 2.0 * 255.0).astype(np.uint8)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.abs(a - b.astype(np.int64)).max() <= 1
    assert got[0].max() > 0
