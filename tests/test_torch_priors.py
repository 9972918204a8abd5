"""The port's monocular-prior layer against the JAX package's, on the CPU:
priors/resize.py against jax.image.resize, the depth alignment, frame
selection, normals from depth, generate_priors on a fixture scene with the
tiny DSINE and Metric3D nets (the same weights on both sides, through the
JAX converter), and the default prior models' lookup."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.priors import depth_align as DAJ
from fusionsense_tpu.priors import frame_select as FSJ
from fusionsense_tpu.priors import mono_priors as MPJ
from fusionsense_tpu.priors.dsine import predictor as JDP
from fusionsense_tpu.priors.metric3d import predictor as JMP
from fusionsense_tpu_torch.priors import depth_align as DAT
from fusionsense_tpu_torch.priors import frame_select as FST
from fusionsense_tpu_torch.priors import mono_priors as MPT
from fusionsense_tpu_torch.priors.dsine import predictor as TDP
from fusionsense_tpu_torch.priors.metric3d import predictor as TMP
from fusionsense_tpu_torch.priors.resize import resize

from prior_cases import build

# resize: the weights are jax.image's exactly; the two apply them with
# float32 sums in different orders (JAX's einsum is farther from a float64
# reference than the port's matmuls on the large upscale)
RESIZE_ATOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape,out", [
    ((7, 9, 3), (13, 5, 3)),          # up one axis, down the other
    ((37, 37, 8), (23, 41, 8)),       # the pos-embed grid, odd sizes
    ((48, 64, 3), (518, 686, 3)),     # Depth-Anything's input upscale
    ((100, 80, 3), (33, 27, 3)),      # a downscale (antialiased)
    ((5, 6), (3, 11)),
])
def test_resize_matches_jax_image_resize(shape, out, method):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = resize(torch.from_numpy(x), out, method).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jax.image.resize(jnp.asarray(x), out, method)), atol=RESIZE_ATOL)


def test_resize_weights_cached_in_inference_mode_serve_autograd():
    """A resize under inference_mode (as the predictors run it) caches its
    weight matrices; a later forward at the same sizes that records a graph
    still differentiates through them, to jax.grad's gradient."""
    x = np.random.default_rng(1).normal(size=(19, 23, 2)).astype(np.float32)
    out = (29, 11, 2)
    with torch.inference_mode():
        resize(torch.from_numpy(x), out, "bicubic")
    xt = torch.from_numpy(x).requires_grad_()
    (resize(xt, out, "bicubic") ** 2).sum().backward()
    want = jax.grad(lambda a: jnp.sum(
        jax.image.resize(a, out, "bicubic") ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               atol=RESIZE_ATOL)


@pytest.mark.parametrize("shape,out", [((5, 7), (10, 14)), ((9, 6), (4, 11)),
                                       ((1, 3), (2, 5)), ((6, 6), (1, 1))])
def test_resize_ac_matches_jax_linspace_form(shape, out):
    """DPT's align_corners=True resize: F.interpolate against the JAX
    package's linspace/gather form, up, down, and with a size of 1. The
    sample positions (i * (H-1)/(h-1) against linspace) differ in their
    last bit, a few 1e-6 on values of order 1."""
    from fusionsense_tpu.priors.depth_anything.dpt import _resize
    from fusionsense_tpu_torch.priors.depth_anything.dpt import resize_ac

    x = np.random.default_rng(2).normal(size=shape + (3,)).astype(np.float32)
    got = resize_ac(torch.from_numpy(x).permute(2, 0, 1)[None], *out)
    np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(),
                               np.asarray(_resize(jnp.asarray(x), *out)),
                               atol=5e-6)


def _depth_pair(seed=0, V=2, H=24, W=32):
    """Mono depth and a sparse metric depth 1.7 * mono + 0.2 with noise
    and holes."""
    rng = np.random.default_rng(seed)
    mono = rng.uniform(0.5, 3.0, size=(V, H, W)).astype(np.float32)
    metric = (1.7 * mono + 0.2 + 0.05 * rng.normal(size=mono.shape)).astype(
        np.float32)
    metric[rng.uniform(size=metric.shape) < 0.4] = 0.0
    return mono, metric


def test_scale_and_shift_lstsq_matches_jax():
    """The same closed form; its float32 sums run in another order than
    XLA's, which moves s by a few parts in 1e6 and t (about 0.2 m, on
    depths of 1 to 5 m) by 1e-5 m."""
    mono, metric = _depth_pair()
    mask = metric > 0.1
    s_t, t_t = DAT.scale_and_shift_lstsq(torch.from_numpy(mono),
                                         torch.from_numpy(metric),
                                         torch.from_numpy(mask))
    s_j, t_j = DAJ.scale_and_shift_lstsq(mono, metric, mask)
    assert s_t.shape == (2,)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=2e-5)
    # an empty mask hits the determinant clamp in both
    z = np.zeros_like(mask)
    s_t, t_t = DAT.scale_and_shift_lstsq(torch.from_numpy(mono),
                                         torch.from_numpy(metric),
                                         torch.from_numpy(z))
    s_j, t_j = DAJ.scale_and_shift_lstsq(mono, metric, z)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))


def test_align_depth_gd_and_align_mono_depths_match_jax():
    """200 Huber-gradient steps (the gradient written out in the port,
    jax.grad in JAX) from the lstsq start, within 1e-5 relative; outliers
    make the Huber's linear branch matter."""
    mono, metric = _depth_pair(1)
    metric[0, :3] += 2.0
    mask = metric > 0.1
    got, (s, t) = DAT.align_depth_gd(torch.from_numpy(mono[0]),
                                     torch.from_numpy(metric[0]),
                                     torch.from_numpy(mask[0]))
    want, (sj, tj) = DAJ.align_depth_gd(mono[0], metric[0], mask[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose([float(s), float(t)], [float(sj), float(tj)],
                               rtol=1e-5)
    got = DAT.align_mono_depths(mono, metric, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(
        DAJ.align_mono_depths(mono, metric)), rtol=1e-5)


def test_frame_select_matches_jax(tmp_path):
    th = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    origins = np.stack([np.cos(th), np.sin(th), 0.1 * th], -1)
    for k in (1, 4, 7, 12, 20):
        assert (FST.farthest_point_camera_selection(origins, k)
                == FSJ.farthest_point_camera_selection(origins, k))
    frames = [{"file_path": f"images/frame_{i:05d}.png",
               "transform_matrix": np.eye(4).tolist()} for i in range(12)]
    for i, fr in enumerate(frames):
        fr["transform_matrix"][0][3] = float(origins[i, 0])
        fr["transform_matrix"][1][3] = float(origins[i, 1])
    outs = []
    for pkg, d in ((FST, tmp_path / "t"), (FSJ, tmp_path / "j")):
        d.mkdir()
        (d / "transforms.json").write_text(json.dumps({"frames": frames}))
        a = pkg.write_splits(d, n_train=5, test_fraction=0.5)
        (d / "train.txt").write_text("frame_00003.png\n\nframe_00007.png\n")
        b = pkg.write_splits(d, train_names=pkg.read_train_txt(
            d / "train.txt"))
        outs.append((a, b, (d / "transforms.json").read_text()))
    assert outs[0] == outs[1]


def test_normals_from_depth_matches_jax():
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:24, 0:32].astype(np.float32)
    depth = (1.0 + 0.01 * xx + 0.02 * yy + 0.003 * rng.normal(
        size=xx.shape)).astype(np.float32)
    got = MPT.NormalsFromDepth(device="cpu").predict_normals_from_depth(
        depth, 30.0, 31.0, 16.0, 12.0)
    want = MPJ.NormalsFromDepth().predict_normals_from_depth(
        depth, 30.0, 31.0, 16.0, 12.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


M3D_INPUT = (56, 98)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from fusionsense_tpu_torch.data.fixture import write_synthetic_scene

    d = tmp_path_factory.mktemp("priors") / "scene"
    return write_synthetic_scene(d, n_views=3, width=64, height=48,
                                 focal=45.0, n_gt=600, device="cpu")


def _generate(scene, tmp_path, tag, pkg_models):
    d = tmp_path / tag
    shutil.copytree(scene, d)
    return d, pkg_models(d)


def _compare_scenes(dt, dj, meta_t, meta_j, depth_tol, normal_tol):
    assert meta_t == meta_j
    assert json.loads((dt / "transforms.json").read_text()) == json.loads(
        (dj / "transforms.json").read_text())
    for sub, tol in (("mono_depth", depth_tol), ("mono_normals", normal_tol)):
        names = sorted(p.name for p in (dt / sub).iterdir())
        assert names == sorted(p.name for p in (dj / sub).iterdir())
        assert names
        for n in names:
            a, b = np.load(dt / sub / n), np.load(dj / sub / n)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, **tol, err_msg=f"{sub}/{n}")


def test_generate_priors_with_nets_matches_jax(scene, tmp_path):
    """Metric3D depth and DSINE normals for every frame: the same files,
    the same transforms.json patch, arrays within the nets' tolerances."""
    dsine, m3d = build("dsine"), build("m3d")
    dt, meta_t = _generate(scene, tmp_path, "torch", lambda d: MPT.generate_priors(
        d, depth_model=TMP.Metric3DPredictor(m3d[0], M3D_INPUT, device="cpu"),
        normal_model=TDP.DSinePredictor(dsine[0], device="cpu"),
        device="cpu"))
    dj, meta_j = _generate(scene, tmp_path, "jax", lambda d: MPJ.generate_priors(
        d, depth_model=JMP.Metric3DPredictor(params=m3d[2], cfg=m3d[4],
                                             input_size=M3D_INPUT),
        normal_model=JDP.DSinePredictor(dsine[2], dsine[4])))
    assert all("mono_depth_file_path" in f and "normal_file_path" in f
               for f in meta_t["frames"])
    _compare_scenes(dt, dj, meta_t, meta_j, dict(rtol=1e-5, atol=1e-6),
                    dict(rtol=2e-4, atol=2e-4))


def test_generate_priors_fallbacks_match_jax(scene, tmp_path):
    """No models: the sensor depth copied, normals from depth."""
    dt, meta_t = _generate(scene, tmp_path, "torch", lambda d: MPT.generate_priors(
        d, device="cpu"))
    dj, meta_j = _generate(scene, tmp_path, "jax", MPJ.generate_priors)
    _compare_scenes(dt, dj, meta_t, meta_j, dict(rtol=0, atol=0),
                    dict(rtol=0, atol=1e-5))


def _patch_loaders(monkeypatch, dsine, metric3d, da):
    """Make each package's predictor constructors record (kind, path)."""
    for cls, kind in ((dsine, "dsine"), (metric3d, "metric3d"),
                      (da, "depth_anything")):
        monkeypatch.setattr(cls, "from_checkpoint", classmethod(
            lambda c, path, *a, _k=kind, **kw: (_k, path)))


def test_default_models_lookup_matches_jax(monkeypatch, tmp_path):
    from fusionsense_tpu.priors.depth_anything import (
        predictor as JAP,
    )
    from fusionsense_tpu_torch.priors.depth_anything import (
        predictor as TAP,
    )

    _patch_loaders(monkeypatch, TDP.DSinePredictor, TMP.Metric3DPredictor,
                   TAP.DepthAnythingModel)
    _patch_loaders(monkeypatch, JDP.DSinePredictor, JMP.Metric3DPredictor,
                   JAP.DepthAnythingModel)
    ck = {k: tmp_path / f"{k}.pt" for k in ("dsine", "m3d", "da", "omni")}
    for p in ck.values():
        p.write_bytes(b"x")
    missing = str(tmp_path / "missing.pt")
    env_cases = [{}, {"DSINE_CHECKPOINT": str(ck["dsine"])},
                 {"METRIC3D_CHECKPOINT": str(ck["m3d"])},
                 {"DEPTH_ANYTHING_CHECKPOINT": str(ck["da"])},
                 {"METRIC3D_CHECKPOINT": missing,
                  "DEPTH_ANYTHING_CHECKPOINT": str(ck["da"])}]
    calls = [(MPT.default_normal_model, MPJ.default_normal_model, a, k)
             for a, k in (((), {}), ((str(ck["dsine"]),), {}),
                          ((missing,), {}),
                          ((), {"model_type": "omnidata"}))]
    calls += [(MPT.default_depth_model, MPJ.default_depth_model, a, k)
              for a, k in (((), {}), ((str(ck["m3d"]),), {}), ((missing,), {}),
                           ((str(ck["da"]),), {"model_type": "depth_anything"}),
                           ((), {"model_type": "depth_anything"}))]
    for env in env_cases:
        for k in ("DSINE_CHECKPOINT", "METRIC3D_CHECKPOINT",
                  "DEPTH_ANYTHING_CHECKPOINT", "OMNIDATA_CHECKPOINT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for port_fn, jax_fn, args, kw in calls:
            assert port_fn(*args, **kw) == jax_fn(*args, **kw), (
                port_fn.__name__, args, kw, env)


def test_omnidata_with_a_checkpoint_raises(monkeypatch, tmp_path):
    """Formerly held the raise of the unported net; now that omnidata is
    ported: a written random checkpoint (the tiny net, wrapped as the
    published .ckpt) loads through default_normal_model, from the path or
    $OMNIDATA_CHECKPOINT, at the asked resolution, and predicts what the
    same net predicts; without a checkpoint the result is None."""
    from fusionsense_tpu_torch.priors.omnidata import convert as TOC
    from fusionsense_tpu_torch.priors.omnidata.predictor import (
        OmnidataPredictor,
    )

    net, sd, _, cfg, _ = build("omni")
    ck = tmp_path / "omnidata.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, ck)
    load = TOC.load_omnidata_checkpoint
    monkeypatch.setattr(TOC, "load_omnidata_checkpoint",
                        lambda path, _cfg=None: load(path, cfg))
    rgb = (np.random.default_rng(2).uniform(size=(40, 56, 3)) * 255).astype(
        np.uint8)
    want = OmnidataPredictor(net, device="cpu").predict_normals(rgb)
    pred = MPT.default_normal_model(str(ck), model_type="omnidata",
                                    device="cpu")
    assert isinstance(pred, OmnidataPredictor) and pred.resolution == "low"
    np.testing.assert_array_equal(pred.predict_normals(rgb), want)
    np.testing.assert_allclose(np.linalg.norm(want, axis=-1), 1.0, atol=1e-5)
    monkeypatch.setenv("OMNIDATA_CHECKPOINT", str(ck))
    pred = MPT.default_normal_model(model_type="omnidata", resolution="hd",
                                    device="cpu")
    assert pred.resolution == "hd" and pred.device.type == "cpu"
    monkeypatch.delenv("OMNIDATA_CHECKPOINT")
    assert MPT.default_normal_model(model_type="omnidata") is None
    assert MPT.default_normal_model(str(tmp_path / "missing.ckpt"),
                                    model_type="omnidata") is None


def test_full_float32_clears_both_tf32_flags_inside_only():
    """The predictors' context turns TF32 off in cuDNN's convolutions and
    in CUDA matmuls, and gives both flags back as they were, also when the
    body raises."""
    from fusionsense_tpu_torch.priors.tf32 import full_float32

    b, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = b.allow_tf32, mm.allow_tf32
    try:
        b.allow_tf32 = mm.allow_tf32 = True
        with full_float32():
            assert (b.allow_tf32, mm.allow_tf32) == (False, False)
        assert (b.allow_tf32, mm.allow_tf32) == (True, True)
        with pytest.raises(KeyError):
            with full_float32():
                raise KeyError
        assert (b.allow_tf32, mm.allow_tf32) == (True, True)
    finally:
        b.allow_tf32, mm.allow_tf32 = old
