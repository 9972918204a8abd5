"""core/ and render/project.py of the port against the JAX package: the same
numpy inputs through both, values at atol 1e-5 and projection gradients at
atol 1e-5, rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.core import cameras as CJ
from fusionsense_tpu.core import sh as SJ
from fusionsense_tpu.core import transforms as TJ
from fusionsense_tpu.render.project import project_gaussians as project_j
from fusionsense_tpu_torch.core import cameras as CT
from fusionsense_tpu_torch.core import sh as ST
from fusionsense_tpu_torch.core import transforms as TT
from fusionsense_tpu_torch.data.synthetic import ring_cameras as ring_t
from fusionsense_tpu_torch.render.project import project_gaussians as project_t

RNG = np.random.RandomState(0)
Q = RNG.normal(size=(64, 4)).astype(np.float32)
V3 = RNG.normal(size=(64, 3)).astype(np.float32)
V3B = RNG.normal(size=(64, 3)).astype(np.float32)
S3 = RNG.uniform(0.01, 0.5, size=(64, 3)).astype(np.float32)
W_SMALL = (1e-5 * RNG.normal(size=(8, 3))).astype(np.float32)
VIEW = np.asarray(jnp.asarray(
    np.linalg.inv(np.array([[0.8, -0.6, 0.0, 0.1], [0.6, 0.8, 0.0, -0.2],
                            [0.0, 0.0, 1.0, 0.3], [0, 0, 0, 1.0]])),
    jnp.float32))
DELTA = (0.1 * RNG.normal(size=(6,))).astype(np.float32)


def _cmp(a_t, a_j, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j),
                               atol=atol, rtol=rtol)


# name -> f(module, to_array): the same call in either package
TRANSFORMS = {
    "normalize": lambda m, a: m.normalize(a(V3)),
    "quat_to_rotmat": lambda m, a: m.quat_to_rotmat(a(Q)),
    "rotation_between": lambda m, a: m.rotation_between(a(V3), a(V3B)),
    "rotation_between_antiparallel": lambda m, a: m.rotation_between(
        a(V3), -a(V3)),
    "quat_scale_to_cov3d": lambda m, a: m.quat_scale_to_cov3d(a(Q), a(S3)),
    "exp_so3": lambda m, a: m.exp_so3(a(V3)),
    "exp_so3_small": lambda m, a: m.exp_so3(a(W_SMALL)),
    "apply_se3_delta": lambda m, a: m.apply_se3_delta(a(VIEW), a(DELTA)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    f = TRANSFORMS[name]
    _cmp(f(TT, torch.tensor), f(TJ, jnp.asarray))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    coeffs = RNG.normal(size=(64, 16, 3)).astype(np.float32)
    dirs = np.asarray(TJ.normalize(jnp.asarray(V3)))
    _cmp(ST.eval_sh(torch.tensor(coeffs), torch.tensor(dirs), degree),
         SJ.eval_sh(jnp.asarray(coeffs), jnp.asarray(dirs), degree))


def test_sh0_roundtrip_matches_jax():
    rgb = RNG.uniform(size=(64, 3)).astype(np.float32)
    _cmp(ST.rgb_to_sh0(torch.tensor(rgb)), SJ.rgb_to_sh0(jnp.asarray(rgb)))
    _cmp(ST.sh0_to_rgb(torch.tensor(rgb)), SJ.sh0_to_rgb(jnp.asarray(rgb)))


def _cams():
    fx = np.float32(60.0)
    cj = CJ.make_camera(jnp.asarray(VIEW), fx, fx, 32.0, 24.0, 64, 48)
    ct = CT.make_camera(VIEW, fx, fx, 32.0, 24.0, 64, 48, device="cpu")
    return cj, ct


def test_camera_helpers_match_jax():
    cj, ct = _cams()
    _cmp(ct.origin, cj.origin)
    _cmp(ct.camtoworld, cj.camtoworld)
    depth = RNG.uniform(0.5, 3.0, size=(48, 64)).astype(np.float32)
    _cmp(CT.backproject_depth(torch.tensor(depth), ct),
         CJ.backproject_depth(jnp.asarray(depth), cj), atol=1e-5, rtol=1e-6)


def test_ring_camera_index_matches_jax():
    from fusionsense_tpu.data.synthetic import ring_cameras as ring_j

    cj = ring_j(n_views=5, width=64, height_px=48, focal=60.0)
    ct = ring_t(n_views=5, width=64, height_px=48, focal=60.0, device="cpu")
    for i in range(5):
        _cmp(ct.index(i).viewmat, cj.index(i).viewmat)
        _cmp(ct.index(i).origin, cj.index(i).origin)


def _gaussians(n=48):
    rng = np.random.RandomState(3)
    means = np.concatenate([rng.uniform(-0.6, 0.6, (n, 2)),
                            rng.uniform(-0.5, 0.5, (n, 1))], -1)
    means = means.astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    op = rng.uniform(0.2, 0.9, n).astype(np.float32)
    return means, quats, scales, op


def _cam_pair():
    from fusionsense_tpu.data.synthetic import ring_cameras as ring_j

    return (ring_j(n_views=3, width=64, height_px=48, focal=60.0).index(1),
            ring_t(n_views=3, width=64, height_px=48, focal=60.0,
                   device="cpu").index(1))


def test_project_values_match_jax():
    cj, ct = _cam_pair()
    g = _gaussians()
    pj = project_j(*[jnp.asarray(a) for a in g], cj)
    pt = project_t(*[torch.tensor(a) for a in g], ct)
    for name in ("mean2d", "depth", "conic", "radius", "compensation"):
        _cmp(getattr(pt, name), getattr(pj, name))
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(pj.valid))


def test_project_gradients_match_jax():
    cj, ct = _cam_pair()
    g = _gaussians()
    n = g[0].shape[0]
    rng = np.random.RandomState(4)
    wm = rng.normal(size=(n, 2)).astype(np.float32)
    wc = (1e-3 * rng.normal(size=(n, 3))).astype(np.float32)
    wd = rng.normal(size=(n,)).astype(np.float32)

    def loss_j(m, q, s):
        p = project_j(m, q, s, jnp.asarray(g[3]), cj)
        return (jnp.sum(p.mean2d * wm) + jnp.sum(p.conic * wc)
                + jnp.sum(p.depth * wd))

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in g[:3]])
    ts = [torch.tensor(a, requires_grad=True) for a in g[:3]]
    p = project_t(*ts, torch.tensor(g[3]), ct)
    loss = (torch.sum(p.mean2d * torch.tensor(wm))
            + torch.sum(p.conic * torch.tensor(wc))
            + torch.sum(p.depth * torch.tensor(wd)))
    gt = torch.autograd.grad(loss, ts)
    for a, b in zip(gt, gj):
        _cmp(a, b, atol=1e-5, rtol=1e-4)
