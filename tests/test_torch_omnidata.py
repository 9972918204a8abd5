"""The port's omnidata normal prior (priors/omnidata/) against the JAX
package's, on the CPU, with the tiny config.

One seeded random torch state dict (tests/prior_cases.py, "omni") goes
into the port's net and, through the JAX package's convert_state_dict, into
flax OmnidataNormals. The forward is compared at the native 64x64 grid and
at 96x96 (the pos-embed's bicubic resample), in float64 at rtol 1e-7 / atol
1e-8 as tests/test_parity_omnidata.py holds the flax net against its torch
replica, and in float32 at rtol 1e-4 / atol 1e-5. The predictor's low and
HD paths are compared with one stub patch net on both sides (the tiny
net's 384x384 forwards would cost JAX a minute here), and once end to end
at low resolution with the tiny net.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from fusionsense_tpu.priors.omnidata import convert as JOC
from fusionsense_tpu.priors.omnidata import dpt_hybrid as JO
from fusionsense_tpu.priors.omnidata import hd_merge as JH
from fusionsense_tpu.priors.omnidata import predictor as JOP
from fusionsense_tpu_torch.priors.omnidata import convert as TOC
from fusionsense_tpu_torch.priors.omnidata import dpt_hybrid as TO
from fusionsense_tpu_torch.priors.omnidata import hd_merge as TH
from fusionsense_tpu_torch.priors.omnidata import predictor as TOP

from prior_cases import build

TOL64 = dict(rtol=1e-7, atol=1e-8)
TOL32 = dict(rtol=1e-4, atol=1e-5)
STUB_ATOL = 1e-5
E2E_ATOL = 1e-4


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
def omni():
    return build("omni")


@pytest.mark.parametrize("side", [64, 96])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_net_matches_flax(omni, side, dtype):
    """64x64 is the tiny config's native 4x4 pos-embed grid; 96x96 resamples
    it to 6x6 with jax.image.resize's cubic."""
    net, sd, params, cfg, jcfg = omni
    img = np.random.default_rng(side).uniform(size=(side, side, 3)).astype(
        np.float32)
    if dtype == "float64":
        tnet = TO.OmnidataNormals(cfg).double()
        tnet.load_state_dict(sd)
        with x64():
            p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
            want = np.asarray(jax.jit(JO.OmnidataNormals(jcfg).apply)(
                {"params": p}, img.astype(np.float64)))
        x, tol = img.astype(np.float64), TOL64
    else:
        tnet, x, tol = net, img, TOL32
        want = np.asarray(jax.jit(JO.OmnidataNormals(jcfg).apply)(
            {"params": params}, img))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x.transpose(2, 0, 1))[None])[0]
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 0), want, **tol)
    assert 0.0 < want.min() and want.max() < 1.0     # the head's ReLU is live


def test_rule_table_and_state_dict_from_flax(omni):
    """The port's parameter names are the published keys: the JAX rule
    table plus refinenet4's dead resConfUnit1; state_dict_from_flax gives
    the state dict back bit for bit, the dead unit as zeros."""
    net, sd, params, cfg, jcfg = omni
    rules = TOC.rules(cfg)
    assert {k: v[0] for k, v in rules.items()} == {
        k: v[0] for k, v in JOC.rules(jcfg).items()}
    dead = set(net.state_dict()) - set(rules)
    assert dead and all(k.startswith(TOC.DEAD_PREFIX) for k in dead)
    back = TOC.state_dict_from_flax(params, cfg)
    assert set(back) == set(sd)
    for k in rules:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k
    for k in dead:
        assert not back[k].any()
    net2 = TO.OmnidataNormals(cfg)
    net2.load_state_dict(back)
    img = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(net2(img), net.eval()(img))


def test_load_checkpoint_lightning_file(omni, tmp_path):
    """The published file's wrapping ({"state_dict": {"model.<key>"}} with
    timm's unused final norm and classifier); a missing key raises."""
    _, sd, _, cfg, _ = omni
    extra = {"pretrained.model.norm.weight": torch.ones(32),
             "pretrained.model.head.weight": torch.zeros(5, 32)}
    path = tmp_path / "omnidata.ckpt"
    torch.save({"state_dict": {f"model.{k}": v
                               for k, v in {**sd, **extra}.items()},
                "epoch": 3}, path)
    net, report = TOC.load_omnidata_checkpoint(str(path), cfg)
    assert not net.training
    assert report == {"missing": [], "unused": sorted(extra)}
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    short = dict(sd)
    short.pop("scratch.output_conv.4.bias")
    torch.save({"state_dict": {f"model.{k}": v for k, v in short.items()}},
               path)
    with pytest.raises(RuntimeError, match="output_conv.4.bias"):
        TOC.load_omnidata_checkpoint(str(path), cfg)


@pytest.mark.parametrize("H,W", [(576, 672), (480, 640), (576, 576)])
def test_hd_merge_equals_jax(H, W):
    """crop_grid, best_fit_rotation and merge_patches on random rotated
    patch fields: the same numpy, the same numbers."""
    assert TH.crop_grid(H, W) == JH.crop_grid(H, W)
    rng = np.random.default_rng(H + W)
    A = rng.normal(size=(300, 3))
    B = A @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T
    np.testing.assert_array_equal(TH.best_fit_rotation(A, B),
                                  JH.best_fit_rotation(A, B))
    _, _, crops = TH.crop_grid(H, W)
    patches = {k: rng.normal(size=(3, 384, 384)).astype(np.float32)
               for k in crops}
    got = TH.merge_patches(patches, H, W)
    assert got.shape == (3, H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JH.merge_patches(patches, H, W))


def _stub_field(rgb01):
    """A patch net stand-in: (S, S, 3) [0, 1] -> (3, S, S) unit normals that
    follow the pixels, so crop offsets and resizes show."""
    out = np.stack([rgb01[..., 0] - 0.5, rgb01[..., 1] - 0.5,
                    0.5 + rgb01[..., 2]])
    return (out / np.linalg.norm(out, axis=0, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("resolution", ["low", "hd"])
@pytest.mark.parametrize("H,W", [(96, 128), (480, 640)])
def test_predictor_paths_match_jax_with_a_stub_net(monkeypatch, resolution,
                                                   H, W):
    """uint8 scaling, the 384x384 resize round trip (low, and hd on a frame
    too small for it), and the HD crops (7 on a 480x640 frame) merged on
    the host, with the same stub patch net on both sides."""
    calls = []

    def jax_stub(self, rgb01):
        assert rgb01.shape == (JOP.IMAGE_SIZE, JOP.IMAGE_SIZE, 3)
        return _stub_field(np.asarray(rgb01))

    def port_stub(self, batch):
        calls.append(batch.shape[0])
        return torch.stack([torch.from_numpy(_stub_field(p.numpy()))
                            for p in batch])

    monkeypatch.setattr(JOP.OmnidataPredictor, "_run_patch", jax_stub)
    monkeypatch.setattr(TOP.OmnidataPredictor, "_run_patches", port_stub)
    rgb = (np.random.default_rng(0).uniform(size=(H, W, 3)) * 255).astype(
        np.uint8)
    want = JOP.OmnidataPredictor(params={}, cfg=JO.tiny_omni(),
                                 resolution=resolution).predict_normals(rgb)
    got = TOP.OmnidataPredictor(TO.OmnidataNormals(TO.tiny_omni()),
                                resolution, device="cpu").predict_normals(rgb)
    assert got.shape == (H, W, 3) and got.dtype == np.float32
    assert calls == [7 if (resolution, H) == ("hd", 480) else 1]
    np.testing.assert_allclose(got, want, atol=STUB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_predictor_low_resolution_matches_jax_end_to_end(omni):
    net, _, params, _, jcfg = omni
    rgb = (np.random.default_rng(1).uniform(size=(96, 128, 3)) * 255).astype(
        np.uint8)
    want = JOP.OmnidataPredictor(params=params, cfg=jcfg,
                                 resolution="low").predict_normals(rgb)
    got = TOP.OmnidataPredictor(net, "low", device="cpu").predict_normals(rgb)
    np.testing.assert_allclose(got, want, atol=E2E_ATOL)
