"""The port's NeRF baseline (baselines/nerf.py) against the JAX package's, on
the CPU, on the sphere scene of tests/test_nerf_baseline.py: its six 48x36
ring cameras (focal 45) and the sphere of radius 0.4, whose z-depth and
normals give the targets; the images are the sphere's normals shaded to
RGB (the rasterized fixture costs 15 s of JAX compilation here).

The port cannot replay JAX's RNG, so each test draws the rays and sample
offsets with JAX's own keys, split exactly as make_train_step splits them
(a step key into (sampling, offsets); sampling into view, row, column),
and feeds the same numbers to both sides. JAX's loss is the package's own
loss_fn, taken from its train step's closure. The hash encoding must be
equal bit for bit, negative corners included. The density-gradient
normals, the gradients and Adam are compared in float64 on both sides: in
float32 the density gradient is a sum of cancelling table terms whose
order differs between the two BLAS, and Adam's normalised step turns a
gradient that small into a step of the learning rate's size.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.baselines import nerf as JN
from fusionsense_tpu.data.synthetic import ring_cameras
from fusionsense_tpu_torch.baselines import nerf as TN
from fusionsense_tpu_torch.convert import camera_from_numpy, nerf_params_from_numpy
from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.data.synthetic import sphere_depth_normals

RENDER_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
ADAM_ATOL = 1e-5
IMAGE_ATOL = 1e-5

# the two configs of tests/test_nerf_baseline.py, fewer levels and rays
DEPTH_CFG = JN.NerfConfig(n_levels=2, table_size_log2=12, max_res=128,
                          n_samples=16, near=0.8, far=3.2, rays_per_step=128,
                          depth_lambda=0.1, lr=1e-2)
NORMAL_CFG = JN.NerfConfig(n_levels=2, table_size_log2=12, max_res=64,
                           n_samples=16, near=0.8, far=3.2, rays_per_step=128,
                           normal_lambda=0.05)


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


def port_cfg(cfg):
    return TN.NerfConfig(**dataclasses.asdict(cfg))


def _t(x):
    """A JAX or numpy array as a torch tensor of its own dtype."""
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def np_params(cfg, seed):
    """Params of init_params' shapes and scales, drawn by numpy (both
    packages get the same numbers; JAX's eager init compiles op by op)."""
    rng = np.random.default_rng(seed)
    T, F, w = 1 << cfg.table_size_log2, cfg.features_per_level, cfg.mlp_width

    def dense(i, o):
        return {"w": (rng.normal(size=(i, o)) * np.sqrt(2.0 / i)).astype(
            np.float32), "b": 0.01 * rng.normal(size=(o,)).astype(np.float32)}

    return {"table": rng.uniform(-1e-4, 1e-4, (cfg.n_levels, T, F)).astype(
                np.float32),
            "d1": dense(cfg.n_levels * F, w), "d2": dense(w, w),
            "density_head": dense(w, 16), "c1": dense(18, w),
            "c2": dense(w, 3)}


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def scene():
    """(JAX cameras, their numpy fields, images, z-depths, world normals)."""
    cams = ring_cameras(n_views=6, width=48, height_px=36, focal=45.0)
    fields = {k: np.asarray(getattr(cams, k))
              for k in ("viewmat", "fx", "fy", "cx", "cy")}
    tcam = camera_from_numpy(dict(fields, width=48, height=36), "cpu")
    deps, nrms = zip(*(sphere_depth_normals(tcam.index(i), radius=0.4)[:2]
                       for i in range(6)))
    normals = torch.stack(nrms).numpy()
    images = np.clip(0.5 + 0.5 * normals, 0.0, 1.0).astype(np.float32)
    return cams, fields, images, torch.stack(deps).numpy(), normals


def port_camera(fields, dtype):
    return Camera(**{k: torch.tensor(v, dtype=dtype)
                     for k, v in fields.items()}, width=48, height=36)


def jax_camera(cams, fields, dtype):
    return dataclasses.replace(cams, **{k: jnp.asarray(v, dtype)
                                        for k, v in fields.items()})


def jax_draw(key, cfg, n_views, H, W):
    """The draws of one JAX train step under `key`, as the port's RayDraw."""
    k1, k2 = jax.random.split(key)
    ka, kb, kc = jax.random.split(k1, 3)
    n = cfg.rays_per_step
    vi, py, px = (jax.random.randint(k, (n,), 0, m)
                  for k, m in ((ka, n_views), (kb, H), (kc, W)))
    u = jax.random.uniform(k2, (n, cfg.n_samples))
    return TN.RayDraw(*(_t(a).long() for a in (vi, py, px)), _t(u))


def jax_train_step(cfg, cams, images, depths, normals):
    """(optax adam, the jitted train chunk, the package's own loss_fn)."""
    opt, chunk = JN.make_train_step(
        cfg, cams, jnp.asarray(images), jnp.asarray(depths),
        None if normals is None else jnp.asarray(normals))
    fn = chunk.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return opt, chunk, cells["loss_fn"].cell_contents


def test_hash_encode_equals_jax_with_negative_corners():
    """Points from well outside the hash box (rays start at z = -2 with a
    bound of 1, so x reaches -0.5 and the corners go negative) to past its
    far side: the encodings are equal bit for bit."""
    cfg = NORMAL_CFG
    p = np_params(cfg, 0)
    tp = nerf_params_from_numpy(p, "cpu")
    pts = np.random.default_rng(0).uniform(-2.2, 2.2, (1000, 3)).astype(
        np.float32)
    assert (np.floor((pts + 1.0) * 0.5 * cfg.base_res) < 0).any()
    # eager, as render_rays calls it: under jit XLA contracts the corner sum
    # into FMAs, which moves its last bits
    want = np.asarray(JN._hash_encode(jnp.asarray(pts), p["table"], cfg))
    got = TN._hash_encode(torch.from_numpy(pts), tp["table"], port_cfg(cfg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_saturates_as_a_uint32_cast():
    """The corner cast saturates (negatives to 0, values past 2^32 - 1 to
    2^32 - 1, past int64's range too) and the products wrap mod 2^32, as
    JAX's uint32 arithmetic (nerf.py:87-89) computes them."""
    T = 1 << 14
    c = np.array([[-3.0, 0.0, 7.0], [-1e9, 5e9, 2.0], [65535.0, 12.0, -0.0],
                  [4294967295.0, 3.0, 1e20]], np.float32)
    h = (jnp.asarray(c).astype(jnp.uint32) * JN._PRIMES[None]).astype(
        jnp.uint32)
    want = np.asarray((h[:, 0] ^ h[:, 1] ^ h[:, 2]) % jnp.uint32(T))
    got = TN._hash(torch.from_numpy(c), T)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _render_rays_both(scene, with_normals, dtype):
    """64 rays through random pixels of the views (the port's rays, fed to
    both), the offsets of one JAX key."""
    _, fields, images, _, _ = scene
    cfg = NORMAL_CFG
    p = _cast(np_params(cfg, 1), dtype)
    rng = np.random.default_rng(3)
    idx = [torch.from_numpy(rng.integers(0, m, 64)) for m in (6, 36, 48)]
    o, d, _ = TN.sample_rays(port_camera(fields, torch.float64),
                             torch.from_numpy(images), None, None, *idx)
    o, d = o.numpy().astype(dtype), d.numpy().astype(dtype)
    key = jax.random.PRNGKey(3)
    want = jax.jit(JN.render_rays, static_argnums=(4, 5))(
        p, o, d, key, cfg, with_normals)
    u = jax.random.uniform(key, (64, cfg.n_samples))
    got = TN.render_rays(_tree_t(p), _t(o), _t(d), _t(u), port_cfg(cfg),
                         with_normals=with_normals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k,
                                   **RENDER_TOL)


def test_render_rays_matches_jax(scene):
    _render_rays_both(scene, False, np.float32)


def test_render_rays_with_normals_matches_jax_in_float64(scene):
    with x64():
        _render_rays_both(scene, True, np.float64)


@pytest.mark.parametrize("variant", ["depth", "normal"])
def test_step_loss_and_gradients_match_jax_in_float64(scene, variant):
    """One step's loss, PSNR and gradients (the normal variant through the
    density gradient's create_graph), the rays drawn by JAX's key."""
    cams, fields, images, depths, normals = scene
    cfg = DEPTH_CFG if variant == "depth" else NORMAL_CFG
    nrm = normals if variant == "normal" else None
    f64 = lambda a: None if a is None else a.astype(np.float64)  # noqa: E731
    key = jax.random.PRNGKey(7)
    p = _cast(np_params(cfg, 0), np.float64)
    with x64():
        *_, loss_fn = jax_train_step(cfg, jax_camera(cams, fields, jnp.float64),
                                     f64(images), f64(depths), f64(nrm))
        (loss, psnr), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p, key)
        draw = jax_draw(key, cfg, 6, 36, 48)
    t = lambda a: None if a is None else _t(f64(a))  # noqa: E731
    tl, tpsnr, tg = TN.loss_and_grads(
        _tree_t(p), draw, port_cfg(cfg), port_camera(fields, torch.float64),
        t(images), t(depths), t(nrm))
    np.testing.assert_allclose(float(tl), float(loss), rtol=1e-9)
    np.testing.assert_allclose(float(tpsnr), float(psnr), rtol=1e-9)
    for path, g in TN._leaves(tg):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), _at(grads, path),
                                   err_msg=str(path), **GRAD_TOL)


def test_five_adam_steps_match_jax_in_float64(scene):
    """Five steps of the depth variant: JAX's scanned train chunk (optax
    adam) against the port's loop (adam written out), with the chunk's
    keys split as JAX splits them."""
    cams, fields, images, depths, _ = scene
    cfg = DEPTH_CFG
    key = jax.random.PRNGKey(11)
    p = _cast(np_params(cfg, 0), np.float64)
    with x64():
        opt, chunk, _ = jax_train_step(
            cfg, jax_camera(cams, fields, jnp.float64),
            images.astype(np.float64), depths.astype(np.float64), None)
        p5, _, m = chunk(p, opt.init(p), key, jnp.zeros((5,)))
        draws = [jax_draw(k, cfg, 6, 36, 48) for k in jax.random.split(key, 5)]
    init, tchunk = TN.make_train_step(
        port_cfg(cfg), port_camera(fields, torch.float64),
        _t(images.astype(np.float64)), _t(depths.astype(np.float64)))
    tp = _tree_t(p)
    t5, state, tm = tchunk(tp, init(tp), draws)
    assert state["count"] == 5
    np.testing.assert_allclose(tm["psnr"].numpy(), np.asarray(m["psnr"]),
                               rtol=1e-9)
    for path, a in TN._leaves(t5):
        np.testing.assert_allclose(a.numpy(), _at(p5, path),
                                   err_msg=str(path), atol=ADAM_ATOL)


def test_render_image_matches_jax(scene):
    """A 36x48 view in chunks of 512 (the last one padded), every chunk
    with the offsets of JAX's default key."""
    cams, fields, *_ = scene
    cfg = DEPTH_CFG
    p = np_params(cfg, 1)
    want = JN.render_image(jax.tree.map(jnp.asarray, p), cams.index(0), cfg,
                           chunk=512)
    u = jax.random.uniform(jax.random.PRNGKey(0), (512, cfg.n_samples))
    got = TN.render_image(_tree_t(p), port_camera(fields, torch.float32).index(0),
                          port_cfg(cfg), u=_t(u), chunk=512)
    for k in ("rgb", "depth"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=IMAGE_ATOL,
                                   err_msg=k)
