"""The port's mesh evaluation against the JAX package's, on the CPU with the
same seeded numpy inputs: global registration, ICP, the chamfer and local
chamfer of chamfer_eval, mesh_eval's sampling and culls, the faro depth
eval; and the in-repo LPIPS net with random weights through
convert_lpips_weights, against the JAX package's lpips_pair."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.core.cameras import make_camera as make_camera_j
from fusionsense_tpu.eval import chamfer as CHJ
from fusionsense_tpu.eval import lpips_jax as LPJ
from fusionsense_tpu.eval import mesh_eval as MEJ
from fusionsense_tpu_torch.core.cameras import make_camera as make_camera_t
from fusionsense_tpu_torch.eval import chamfer as CHT
from fusionsense_tpu_torch.eval import lpips as LPT
from fusionsense_tpu_torch.eval import lpips_vgg as LPV
from fusionsense_tpu_torch.eval import mesh_eval as MET

RTOL = 1e-6   # the same host numpy / scipy code on the same inputs


def _clouds(seed=0, n=800):
    """A noisy ellipsoid and its copy rotated 90 degrees, scaled, moved."""
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    gt = d * np.array([0.3, 0.2, 0.12])
    R = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    pred = (gt @ R.T) * 1.1 + np.array([0.05, -0.02, 0.01])
    pred += 0.003 * rng.normal(size=pred.shape)
    return pred.astype(np.float32), gt.astype(np.float32) * 1e3   # GT in mm


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, equal_nan=True)


def test_registration_and_icp_match_jax():
    pred, gt = _clouds()
    gt = gt * 1e-3
    _close(CHT._so3_candidates(), CHJ._so3_candidates())
    _close(CHT.global_rotation_init(pred, gt), CHJ.global_rotation_init(pred, gt))
    _close(CHT._umeyama(pred.astype(np.float64), gt.astype(np.float64)),
           CHJ._umeyama(pred.astype(np.float64), gt.astype(np.float64)))
    at, (st, Rt, tt) = CHT.icp_align(pred, gt, iterations=20)
    aj, (sj, Rj, tj) = CHJ.icp_align(pred, gt, iterations=20)
    _close((at, st, Rt, tt), (aj, sj, Rj, tj))


@pytest.mark.parametrize("mode", ["at_site", "exclude_site"])
def test_local_chamfer_matches_jax(mode):
    pred, gt = _clouds(1)
    gt = gt * 1e-3
    centers = np.array([[0.3, 0, 0], [0, 0.2, 0], [0, 0, 5.0]])
    got = CHT.local_chamfer(pred, gt, centers, radius=0.08, mode=mode)
    _close(got, CHJ.local_chamfer(pred, gt, centers, radius=0.08, mode=mode))
    assert np.isfinite(got[:2]).all() and (mode == "exclude_site"
                                           or np.isnan(got[2]))


def test_chamfer_eval_matches_jax():
    pred, gt = _clouds(2)
    centers = np.array([[0.3, 0, 0], [0, 0.2, 0]])
    kw = dict(gt_unit_scale=1e-3, sample=500, touch_centers=centers,
              touch_radius=0.08)
    got = CHT.chamfer_eval(pred, gt, **kw)
    _close(got, CHJ.chamfer_eval(pred, gt, **kw))
    assert got["chamfer_x1e3"] < 1.0 and len(got["local_chamfer_x1e3"]) == 2


def _ring(n=4, w=64, h=48):
    """n cameras on a ring around the origin, looking at it (OpenCV)."""
    mats = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([1.5 * np.cos(a), 1.5 * np.sin(a), 0.4])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        mats.append(np.linalg.inv(c2w))
    vm = np.stack(mats).astype(np.float32)
    ones = np.ones(n, np.float32)
    args = (50.0 * ones, 50.0 * ones, w / 2 * ones, h / 2 * ones, w, h)
    return (make_camera_j(jnp.asarray(vm), *[jnp.asarray(a) for a in args[:4]],
                          w, h),
            make_camera_t(vm, *args, device="cpu"))


def _mesh():
    from fusionsense_tpu.mesh.marching import marching_tetrahedra

    g = np.linspace(-0.5, 0.5, 20)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return marching_tetrahedra(np.sqrt(X ** 2 + Y ** 2 + (Z / 0.7) ** 2) - 0.3,
                               origin=(-0.5, -0.5, -0.5), spacing=1 / 19)


def test_mesh_eval_matches_jax():
    verts, faces = _mesh()
    cj, ct = _ring()
    gt = MEJ.sample_mesh_points(verts, faces, 3000, seed=5) * 1.02
    _close(MET.sample_mesh_points(verts, faces, 500, seed=3),
           MEJ.sample_mesh_points(verts, faces, 500, seed=3))
    np.testing.assert_array_equal(MET.visible_mask(gt, ct),
                                  MEJ.visible_mask(gt, cj))
    got = MET.mesh_eval(verts, faces, gt, cameras=ct, n_samples=4000)
    _close(got, MEJ.mesh_eval(verts, faces, gt, cameras=cj, n_samples=4000))
    assert "culled_chamfer_x1e3" in got


def _depths(cj, pts):
    """z-buffer depth maps of a dense cloud, 0 where nothing projects."""
    vm = np.asarray(cj.viewmat)
    out = []
    for i in range(vm.shape[0]):
        p = pts @ vm[i, :3, :3].T + vm[i, :3, 3]
        u = np.clip((p[:, 0] / p[:, 2] * 50 + 32).astype(int), 0, 63)
        v = np.clip((p[:, 1] / p[:, 2] * 50 + 24).astype(int), 0, 47)
        d = np.full((48, 64), np.inf, np.float32)
        np.minimum.at(d, (v, u), p[:, 2].astype(np.float32))
        out.append(np.where(np.isfinite(d), d, 0.0).astype(np.float32))
    return np.stack(out)


def test_depth_cull_and_faro_eval_match_jax():
    verts, faces = _mesh()
    cj, ct = _ring()
    cloud = MEJ.sample_mesh_points(verts, faces, 20000, seed=1)
    depths = _depths(cj, cloud)
    pts = MEJ.sample_mesh_points(verts, faces, 2000, seed=2) * 1.05
    np.testing.assert_array_equal(
        MET.depth_cull_mask(pts, ct, torch.tensor(depths)),
        MEJ.depth_cull_mask(pts, cj, depths))
    render = depths * np.float32(1.01)
    got = MET.faro_depth_eval(torch.tensor(render), cloud, ct)
    want = MEJ.faro_depth_eval(render, cloud, cj)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------- LPIPS ----

def _random_lpips_states(seed=0):
    """Random torchvision-layout VGG-16 features and LPIPS heads (heads
    non-negative, as the published ones)."""
    rng = np.random.RandomState(seed)
    vgg, cin = {}, 3
    for slice_convs in LPV.VGG_SLICES:
        for idx, cout in slice_convs:
            vgg[f"features.{idx}.weight"] = torch.tensor(
                rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
            vgg[f"features.{idx}.bias"] = torch.tensor(
                rng.normal(0, 0.05, cout).astype(np.float32))
            cin = cout
    lins = {f"lin{i}.model.1.weight": torch.tensor(np.abs(rng.normal(
        0, 0.05, (1, c[-1][1], 1, 1))).astype(np.float32))
        for i, c in enumerate(LPV.VGG_SLICES)}
    return vgg, lins


def test_lpips_net_matches_jax(tmp_path, monkeypatch):
    """convert_lpips_weights gives the JAX converter's params; the net
    gives lpips_pair's distance within rtol 2e-4 (tests/test_parity_lpips.py
    holds lpips_pair to a torch replica at the same tolerance); the .npz
    written by either package loads in the other, and eval/lpips selects
    the net when the file is there."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    vgg, lins = _random_lpips_states()
    params = LPV.convert_lpips_weights(vgg, lins)
    params_j = LPJ.convert_lpips_weights(vgg, lins)
    for k, v in params_j.items():
        node = params[k]
        for kk in (v if isinstance(v, dict) else {None: v}):
            a = node[kk] if kk else node
            b = v[kk] if kk else v
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    net = LPV.LPIPSVGG(params)
    with torch.no_grad():
        got = float(net(torch.tensor(a), torch.tensor(b)))
        same = float(net(torch.tensor(a), torch.tensor(a)))
    want = float(LPJ.lpips_pair(params_j, a, b))
    assert want > 0 and same < 1e-6
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)

    path = tmp_path / "lpips_vgg.npz"
    LPV.save_lpips_params(path, params)
    np.testing.assert_allclose(
        float(LPJ.lpips_pair(LPJ.load_lpips_params(str(path)), a, b)), want,
        rtol=1e-6)
    monkeypatch.setenv("FUSIONSENSE_LPIPS_WEIGHTS", str(path))
    monkeypatch.setattr(LPT, "_kind", None)
    monkeypatch.setattr(LPT, "_net", None)
    assert LPT.available() and LPT._kind == "vgg"
    np.testing.assert_allclose(LPT.lpips(a, b), got, rtol=1e-6)
