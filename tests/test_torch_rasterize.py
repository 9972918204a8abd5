"""The port's rasterizer against the JAX rasterize, backend by backend: the
cases of tests/test_pallas_composite.py, run on the CPU (the port through
the plain K1/K2 and K3/K4, the JAX package with its Pallas kernels in
interpret mode), with the same numpy scene fed to both packages; and the
port's naive O(HWN) oracle against the JAX one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.core.cameras import make_camera as make_camera_j
from fusionsense_tpu.core.transforms import random_quats
from fusionsense_tpu.render import RasterizeConfig as RCJ
from fusionsense_tpu.render import rasterize as rasterize_j
from fusionsense_tpu.render.naive import rasterize_naive as naive_j
from fusionsense_tpu_torch.core.cameras import make_camera as make_camera_t
from fusionsense_tpu_torch.render.naive import rasterize_naive as naive_t
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from fusionsense_tpu_torch.render.rasterize import rasterize as rasterize_t

KW = dict(tile_size=16, tile_capacity=256, max_tiles_per_gaussian=16,
          tile_chunk=8, sh_degree=0, backend="flat", pallas_chunk=128)
CFG_J, CFG_T = RCJ(**KW), RCT(**KW)


def scene(seed, n=40):
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    means = jnp.concatenate(
        [jax.random.uniform(k1, (n, 2), minval=-0.5, maxval=0.5),
         jax.random.uniform(k2, (n, 1), minval=1.0, maxval=3.0)], -1)
    quats = random_quats(k3, n)
    scales = jax.random.uniform(k4, (n, 3), minval=0.02, maxval=0.1)
    opac = jax.random.uniform(k5, (n,), minval=0.3, maxval=0.95)
    colors = jax.random.uniform(jax.random.PRNGKey(7), (n, 3))
    return [np.asarray(a) for a in (means, quats, scales, opac, colors)]


def stacked(n=300):
    """Opaque splats stacked on the axis: > 2 blocks force block skipping."""
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = 1.0 + 0.002 * np.arange(n)
    quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    scales = np.full((n, 3), 0.3, np.float32)
    opac = np.full((n,), 0.9, np.float32)
    colors = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (n, 3)))
    return [means, quats, scales, opac, colors]


def cams(w, h):
    cx, cy = w / 2, h / 2
    return (make_camera_j(jnp.eye(4), 80.0, 80.0, cx, cy, w, h),
            make_camera_t(np.eye(4), 80.0, 80.0, cx, cy, w, h, device="cpu"))


def both(sc, w, h, cfg_kw=None):
    cj, ct = cams(w, h)
    cfg_j = dataclasses.replace(CFG_J, **(cfg_kw or {}))
    cfg_t = dataclasses.replace(CFG_T, **(cfg_kw or {}))
    out_j = jax.jit(lambda *a: rasterize_j(*a, cj, cfg_j))(
        *[jnp.asarray(a) for a in sc])
    out_t = rasterize_t(*[torch.tensor(a) for a in sc], ct, cfg_t,
                        device="cpu")
    return out_j, out_t


def _close_fwd(out_j, out_t, atol_rgb=3e-4, atol_geo=3e-3):
    for name, atol in (("rgb", atol_rgb), ("alpha", atol_rgb),
                       ("depth", atol_geo), ("normal", atol_geo)):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   atol=atol, err_msg=name)


def test_flat_forward_matches_jax():
    out_j, out_t = both(scene(0), 64, 48)
    _close_fwd(out_j, out_t)
    assert int(out_t.overflow) == int(out_j.overflow) == 0
    np.testing.assert_array_equal(out_t.radius.numpy(), np.asarray(out_j.radius))


def test_flat_saturated_early_exit_matches_jax():
    out_j, out_t = both(stacked(), 32, 32, dict(tile_capacity=512))
    assert int(out_t.overflow) == 0
    _close_fwd(out_j, out_t)


def test_flat_budget_overflow_reported():
    out_j, out_t = both(scene(4, n=200), 64, 48, dict(tile_capacity=16))
    assert int(out_t.overflow) == int(out_j.overflow) > 0
    assert torch.all(torch.isfinite(out_t.rgb))
    _close_fwd(out_j, out_t)


def _loss_j(cfg, cam, target):
    def f(m, q, s, o, c, tap, abst):
        out = rasterize_j(m, q, s, o, c, cam, cfg, mean2d_tap=tap,
                          absgrad_tap=abst)
        return (jnp.mean((out.rgb - target) ** 2) + 0.01 * jnp.mean(out.depth)
                + 0.05 * jnp.mean(out.alpha))
    return f


def _grads_t(sc, cam, cfg, target):
    ts = [torch.tensor(a, requires_grad=True) for a in sc]
    n = sc[0].shape[0]
    tap = torch.zeros((n, 2), requires_grad=True)
    abst = torch.zeros((n, 2), requires_grad=True)
    out = rasterize_t(*ts, cam, cfg, mean2d_tap=tap, absgrad_tap=abst,
                      device="cpu")
    tgt = torch.tensor(np.asarray(target))
    loss = (torch.mean((out.rgb - tgt) ** 2) + 0.01 * torch.mean(out.depth)
            + 0.05 * torch.mean(out.alpha))
    # the "jax" backend has no absgrad tap: its gradient is zero, as in JAX
    gs = torch.autograd.grad(loss, ts + [tap, abst], allow_unused=True)
    return [np.zeros(x.shape, np.float32) if g is None else g.numpy()
            for g, x in zip(gs, ts + [tap, abst])]


def _backward_matches_jax(kw):
    sc = scene(1, n=15)
    cj, ct = cams(32, 32)
    target = jnp.full((32, 32, 3), 0.4)
    cfg_j = dataclasses.replace(CFG_J, **kw)
    cfg_t = dataclasses.replace(CFG_T, **kw)
    tap = jnp.zeros((15, 2))
    g_j = jax.jit(jax.grad(_loss_j(cfg_j, cj, target),
                           argnums=tuple(range(7))))(
        *[jnp.asarray(a) for a in sc], tap, tap)
    g_t = _grads_t(sc, ct, cfg_t, target)
    for a, b in zip(g_t, g_j):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=2e-2)


@pytest.mark.parametrize("transpose", ["landing", "scatter"])
def test_flat_backward_matches_jax(transpose):
    _backward_matches_jax(dict(flat_grad_transpose=transpose))


def test_flat_absgrad_tap():
    sc = scene(3, n=12)
    _, ct = cams(32, 32)
    g = _grads_t(sc, ct, CFG_T, np.full((32, 32, 3), 0.2, np.float32))
    g_signed, g_abs = g[5], g[6]
    assert np.all(np.isfinite(g_abs)) and g_abs.sum() > 0
    assert np.all(g_abs >= np.abs(g_signed) - 1e-6)


def test_flat_grad_transpose_scatter_matches_landing():
    sc = scene(3, n=25)
    _, ct = cams(32, 32)
    target = np.full((32, 32, 3), 0.4, np.float32)
    g_s = _grads_t(sc, ct, dataclasses.replace(CFG_T, flat_grad_transpose="scatter"),
                   target)
    g_l = _grads_t(sc, ct, dataclasses.replace(CFG_T, flat_grad_transpose="landing"),
                   target)
    for a, b in zip(g_s, g_l):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(blend_bf16=True),
                                dict(backend="pallas", blend_bf16=True),
                                dict(backend="other"),
                                dict(flat_grad_transpose="other")])
def test_options_off_the_slice_raise(kw):
    sc = scene(0, n=5)
    _, ct = cams(32, 32)
    with pytest.raises(NotImplementedError):
        rasterize_t(*[torch.tensor(a) for a in sc], ct,
                    dataclasses.replace(CFG_T, **kw), device="cpu")


def test_inputs_off_the_requested_device_raise():
    sc = scene(0, n=5)
    _, ct = cams(32, 32)
    with pytest.raises(ValueError):
        rasterize_t(*[torch.tensor(a) for a in sc], ct, CFG_T,
                    device="meta")


# ------------------------------------------------- dense backends ------

DENSE = ["jax", "pallas"]


@pytest.mark.parametrize("backend", DENSE)
def test_dense_forward_matches_jax(backend):
    out_j, out_t = both(scene(0), 64, 48, dict(backend=backend))
    _close_fwd(out_j, out_t)
    for name in ("overflow", "truncated", "trunc_by_win"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)))
    np.testing.assert_array_equal(out_t.radius.numpy(), np.asarray(out_j.radius))
    assert int(out_t.pairs_used) == 0


@pytest.mark.parametrize("backend", DENSE)
def test_dense_backward_matches_jax(backend):
    """Gradients of every input and of both taps (signed and absolute)."""
    _backward_matches_jax(dict(backend=backend))


@pytest.mark.parametrize("backend", DENSE)
def test_dense_saturated_stack_matches_jax(backend):
    """300 opaque splats stacked on the axis: pallas stops compositing a
    tile's chunks once it saturates, and the image must not change."""
    out_j, out_t = both(stacked(), 32, 32,
                        dict(backend=backend, tile_capacity=512))
    assert int(out_t.overflow) == int(out_j.overflow) == 0
    _close_fwd(out_j, out_t)


def test_pallas_absgrad_tap():
    sc = scene(3, n=12)
    _, ct = cams(32, 32)
    g = _grads_t(sc, ct, dataclasses.replace(CFG_T, backend="pallas"),
                 np.full((32, 32, 3), 0.2, np.float32))
    g_signed, g_abs = g[5], g[6]
    assert np.all(np.isfinite(g_abs)) and g_abs.sum() > 0
    assert np.all(g_abs >= np.abs(g_signed) - 1e-6)


def test_naive_matches_jax():
    sc = scene(5, n=30)
    cj, ct = cams(40, 24)
    cfg = dict(sh_degree=0)
    out_j = jax.jit(lambda *a: naive_j(*a, cj, RCJ(**cfg)))(
        *[jnp.asarray(a) for a in sc])
    out_t = naive_t(*[torch.tensor(a) for a in sc], ct, RCT(**cfg),
                    device="cpu")
    for name in ("rgb", "alpha", "depth", "normal"):
        np.testing.assert_allclose(out_t[name].numpy(), np.asarray(out_j[name]),
                                   atol=1e-5, err_msg=name)


def test_rasterize_without_cfg_uses_the_jax_default():
    """No cfg means RasterizeConfig(), whose backend is "jax" in both
    packages, and the default render agrees with the JAX one."""
    import inspect

    assert RCT() == RCT(**dataclasses.asdict(RCJ()))
    assert inspect.signature(rasterize_t).parameters["cfg"].default == RCT()
    sc = scene(0, n=20)
    cj, ct = cams(48, 32)
    out_j = jax.jit(lambda *a: rasterize_j(*a, cj))(*[jnp.asarray(a) for a in sc])
    out_t = rasterize_t(*[torch.tensor(a) for a in sc], ct, device="cpu")
    _close_fwd(out_j, out_t)
