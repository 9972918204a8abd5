"""Touch anchoring, pruning and the tactile helpers of the port against the
JAX package: add_touch_patches (slots, colours, frozen flags, zeroed
moments), in_any_box, touch_prune, hull_prune, sphere_touch_patches,
oriented_bbox, lift_normals_2d and load_touch_patches. Masks exactly,
values at atol 1e-6."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.data import synthetic as SYNJ
from fusionsense_tpu.data import tactile as TACJ
from fusionsense_tpu.gaussians import touch as TJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.train import optim as OJ
from fusionsense_tpu.utils.ply import write_pcd as write_pcd_j
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.data import synthetic as SYNT
from fusionsense_tpu_torch.data import tactile as TACT
from fusionsense_tpu_torch.gaussians import touch as TT
from fusionsense_tpu_torch.utils import ply as PLYT


def _np(tree):
    return {k: np.asarray(v) for k, v in dict(tree).items()}


def _patches(n_patches=2, pts=60):
    pj = SYNJ.sphere_touch_patches(n_patches=n_patches, pts_per_patch=pts)
    return pj, convert.touch_patches_from_numpy(
        [dataclasses.asdict(p) for p in pj])


def _state(n_alive, capacity, seed=0):
    """Gaussians on and near the sphere, some inside the patch boxes."""
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(max(n_alive, 1), 3))
    pts = 0.5 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    pts = (pts + 0.01 * rng.normal(size=pts.shape)).astype(np.float32)
    rgb = rng.uniform(size=pts.shape).astype(np.float32)
    s = init_j(jnp.asarray(pts), jnp.asarray(rgb), capacity=capacity,
               sh_degree=1)
    alive = np.zeros(capacity, bool)
    alive[:n_alive] = True
    frozen = np.zeros(capacity, bool)
    frozen[: n_alive // 10] = True
    s = s.replace(alive=jnp.asarray(alive), frozen=jnp.asarray(frozen))
    opt = OJ.init_adam(s.params())
    for tree in (opt.m, opt.v, opt.acc):
        for k, v in tree.items():
            tree[k] = jnp.ones_like(v)
    return s, opt


def _to_torch(s, opt):
    return (convert.state_from_numpy(_np(s), "cpu"),
            convert.adam_from_numpy({"m": _np(opt.m), "v": _np(opt.v),
                                     "acc": _np(opt.acc),
                                     "counts": _np(opt.counts)}, "cpu"))


@pytest.mark.parametrize("n_alive,capacity", [(300, 512), (0, 256), (200, 260)],
                         ids=["intruders", "none_alive", "too_few_free_slots"])
def test_add_touch_patches_matches_jax(n_alive, capacity):
    pj, pt = _patches()
    s, opt = _state(n_alive, capacity)
    sj, oj, bj = TJ.add_touch_patches(s, opt, pj, gel_scale=0.01,
                                      scene_scale=1.5)
    st, ot, bt = TT.add_touch_patches(*_to_torch(s, opt), pt, gel_scale=0.01,
                                      scene_scale=1.5)
    for k, v in st.fields().items():
        want = np.asarray(getattr(sj, k))
        if v.dtype == torch.bool:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, atol=1e-6, rtol=0,
                                       err_msg=k)
    for tree in ("m", "v", "acc"):
        for k, v in getattr(ot, tree).items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(oj, tree)[k]))
    for f in ("centers", "rots", "extents"):
        np.testing.assert_allclose(getattr(bt, f).numpy(),
                                   np.asarray(getattr(bj, f)), atol=1e-7)
    new = int((st.frozen.numpy() & ~np.asarray(s.frozen)).sum())
    free_before = capacity - (int(st.num_alive) - new)
    assert new == min(120, free_before)         # 120 patch points
    assert not ot.m["means"].numpy()[st.frozen.numpy()
                                     & ~np.asarray(s.frozen)].any()
    if n_alive == 300:
        # intruders were culled before the patches went in
        assert int(st.num_alive) < n_alive + 120


def test_prune_and_boxes_match_jax():
    pj, pt = _patches()
    s, opt = _state(300, 512, seed=1)
    sj, _, bj = TJ.add_touch_patches(s, opt, pj, gel_scale=0.01)
    st, _, bt = TT.add_touch_patches(*_to_torch(s, opt), pt, gel_scale=0.01)
    # drift live Gaussians into the boxes, then prune
    live = np.flatnonzero(np.asarray(sj.alive & ~sj.frozen))[:20]
    means = np.asarray(sj.means).copy()
    means[live] = np.concatenate([p.points[:10] for p in pj])
    sj = sj.replace(means=jnp.asarray(means))
    st = st.replace(means=torch.tensor(means))
    inside_j = np.asarray(TJ.in_any_box(jnp.asarray(means), bj))
    np.testing.assert_array_equal(
        TT.in_any_box(torch.tensor(means), bt).numpy(), inside_j)
    assert inside_j[live].all()
    pj_out = TJ.touch_prune(sj, bj)
    pt_out = TT.touch_prune(st, bt)
    np.testing.assert_array_equal(pt_out.alive.numpy(), np.asarray(pj_out.alive))
    assert not pt_out.alive.numpy()[live].any()
    np.testing.assert_array_equal(pt_out.frozen.numpy(), st.frozen.numpy())


def test_hull_prune_matches_jax(monkeypatch):
    hull = np.asarray(SYNJ.sphere_points(n=4000, radius=0.1)[0])
    rng = np.random.RandomState(2)
    d = rng.normal(size=(200, 3))
    r = rng.uniform(0.08, 0.16, (200, 1))
    means = (r * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    s = init_j(jnp.asarray(means), jnp.full((200, 3), 0.5), capacity=256,
               sh_degree=1)
    s = s.replace(frozen=s.frozen.at[:10].set(True))
    oj = TJ.hull_prune(s, jnp.asarray(hull), scene_scale=1.0)
    ot = TT.hull_prune(convert.state_from_numpy(_np(s), "cpu"),
                       torch.tensor(hull), scene_scale=1.0)
    np.testing.assert_array_equal(ot.alive.numpy(), np.asarray(oj.alive))
    # the candidates' distances in many (candidate, hull) blocks
    monkeypatch.setattr(TT, "_BLOCK", 1 << 12)
    small = TT.hull_prune(convert.state_from_numpy(_np(s), "cpu"),
                          torch.tensor(hull), scene_scale=1.0)
    np.testing.assert_array_equal(small.alive.numpy(), np.asarray(oj.alive))
    culled = np.asarray(s.alive) & ~ot.alive.numpy()
    assert 0 < culled.sum() < 190 and not culled[:10].any()


def test_tactile_helpers_match_jax():
    for pj, pt in zip(*_patches(n_patches=4, pts=400)):
        for f in ("points", "colors", "normals", "bbox_center", "bbox_rot",
                  "bbox_extent"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
        assert TACT.points_in_obb(pt.points, pt.bbox_center, pt.bbox_rot,
                                  pt.bbox_extent).all()
    direct = SYNT.sphere_touch_patches(n_patches=4, pts_per_patch=400)
    for a, b in zip(direct, SYNJ.sphere_touch_patches(n_patches=4,
                                                      pts_per_patch=400)):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.bbox_rot, b.bbox_rot)
    rng = np.random.RandomState(3)
    pts = rng.randn(300, 3) * [2.0, 0.5, 0.1] + 4.0
    for a, b in zip(TACT.oriented_bbox(pts, pad=1e-3),
                    TACJ.oriented_bbox(pts, pad=1e-3)):
        np.testing.assert_array_equal(a, b)
    n2d = rng.uniform(-0.8, 0.8, (64, 2))
    np.testing.assert_array_equal(TACT.lift_normals_2d(n2d),
                                  TACJ.lift_normals_2d(n2d))
    pts_t = torch.tensor(pts)
    c, R, e = (torch.tensor(x.copy()) for x in TACT.oriented_bbox(pts))
    assert bool(TACT.points_in_obb(pts_t, c, R, e).all())


def test_load_touch_patches_matches_jax(tmp_path):
    """Two frames written by the JAX package's writer (one with 2D normals
    and an .npy contact mask, one with colours and no normals), read by
    both packages."""
    rng = np.random.RandomState(4)
    pts = (rng.rand(250, 3) * [100.0, 100.0, 5.0]).astype(np.float32)
    write_pcd_j(tmp_path / "patch_0.pcd", pts,
                extra={"normal_x": rng.uniform(-0.3, 0.3, 250).astype(np.float32),
                       "normal_y": rng.uniform(-0.3, 0.3, 250).astype(np.float32)})
    np.save(tmp_path / "mask_0.npy", rng.rand(250) > 0.3)
    PLYT.write_pcd(tmp_path / "patch_1.pcd", pts[:150],
                   colors=rng.uniform(size=(150, 3)))
    T0, T1 = np.eye(4), np.eye(4)
    T0[:3, 3] = [0.1, 0.2, 0.3]
    T1[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    meta = {"gel_scale": 6.34e-5,
            "frames": [{"file_path": "patch_0.pcd", "mask_path": "mask_0.npy",
                        "transform_matrix": T0.tolist()},
                       {"file_path": "patch_1.pcd",
                        "transform_matrix": T1.tolist()}]}
    with open(tmp_path / "gelsight_transform.json", "w") as f:
        json.dump(meta, f)
    kw = dict(translate=np.array([0.0, 0.1, 0.0]), scale=2.0)
    got = TACT.load_touch_patches(tmp_path / "gelsight_transform.json", **kw)
    want = TACJ.load_touch_patches(tmp_path / "gelsight_transform.json", **kw)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for f in ("points", "colors", "normals", "bbox_center", "bbox_rot",
                  "bbox_extent"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert len(got[0].points) < 50 and len(got[1].points) == 30
