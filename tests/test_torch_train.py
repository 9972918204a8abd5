"""Losses, optimizer, ADC stats, compaction, the step body, Trainer.run and
the presets of the port against the JAX package on a small fixture: 3 views
at 64x48, tile 16, capacity 2048, bin_refresh_steps = 2 * V, the flat
backend and the dense ones (which ignore the bin cache). Both packages start
from the same numpy state (convert.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fusionsense_tpu.config as CFJ
import fusionsense_tpu.train.losses as LJ
import fusionsense_tpu_torch.config as CFT
import fusionsense_tpu_torch.train.losses as LT
from fusionsense_tpu.data import synthetic as SYNJ
from fusionsense_tpu.gaussians import adc as ADCJ
from fusionsense_tpu.gaussians import resize as RSJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.gaussians.store import activated as activated_j
from fusionsense_tpu.render.rasterize import RasterizeConfig as RCJ
from fusionsense_tpu.render.rasterize import rasterize as rasterize_j
from fusionsense_tpu.train import optim as OJ
from fusionsense_tpu.train import trainer as TRJ
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.data import synthetic as SYNT
from fusionsense_tpu_torch.gaussians import adc as ADCT
from fusionsense_tpu_torch.gaussians import resize as RST
from fusionsense_tpu_torch.gaussians.init import (
    init_from_points as init_t, knn_mean_dist as knn_t,
)
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from fusionsense_tpu_torch.train import optim as OT
from fusionsense_tpu_torch.train import trainer as TRT

V, W, H = 3, 64, 48
RKW = dict(tile_size=16, tile_capacity=128, max_tiles_per_gaussian=9,
           sh_degree=3, backend="flat")


def _cfg(mod, rc_cls, backend="flat", **train_kw):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(sh_degree=3,
                              rasterize=rc_cls(**dict(RKW, backend=backend)),
                              capacity=2048, binary_opacities=False),
        train=mod.TrainConfig(iterations=12, scan_chunk=4, log_every=4,
                              bin_refresh_steps=2 * V, **train_kw),
        loss=mod.LossConfig())


def _np_tree(x):
    return {k: np.asarray(v) for k, v in dict(x).items()}


@pytest.fixture(scope="module")
def fixture():
    cams_j = SYNJ.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0)
    pts, rgb, nrm = SYNJ.sphere_points(n=400, radius=0.5)
    gt = init_j(pts, rgb, capacity=512, sh_degree=3, seed_normals=nrm,
                init_opacity=0.95)
    m, q, s, o, c = activated_j(gt)
    rc = RCJ(**dict(RKW, tile_capacity=512))
    render = jax.jit(lambda i: rasterize_j(m, q, s, o, c, cams_j.index(i), rc).rgb)
    images = np.stack([np.asarray(render(i)) for i in range(V)])
    dn = [SYNJ.sphere_depth_normals(cams_j.index(i)) for i in range(V)]
    data = {"images": images,
            "sensor_depths": np.stack([np.asarray(d[0]) for d in dn]),
            "normals": np.stack([np.asarray(d[1]) for d in dn])}
    pts2, _, nrm2 = SYNJ.sphere_points(n=150, radius=0.5)
    rng = np.random.RandomState(0)
    pts2 = np.asarray(pts2) + 0.03 * rng.randn(150, 3).astype(np.float32)
    init = init_j(jnp.asarray(pts2), jnp.full((150, 3), 0.5), capacity=2048,
                  sh_degree=3, seed_normals=nrm2)
    return cams_j, data, _np_tree(init), pts2, np.asarray(nrm2)


def _torch_side(fx):
    cams_j, data, init, _, _ = fx
    cams_t = SYNT.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0,
                               device="cpu")
    return (cams_t, convert.train_data_from_numpy(data, "cpu"),
            convert.state_from_numpy(init, "cpu"))


def _jax_side(fx):
    cams_j, data, init, _, _ = fx
    from fusionsense_tpu.gaussians.store import GaussianState

    state = GaussianState(**{k: jnp.asarray(v) for k, v in init.items()})
    return (cams_j, TRJ.TrainData(**{k: jnp.asarray(v) for k, v in data.items()}),
            state)


# ------------------------------------------------------------- losses ------

def _imgs(seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    d1 = rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)
    d2 = (d1 + 0.2 * rng.normal(size=d1.shape)).astype(np.float32)
    m = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
    return a, b, d1, d2, m


LOSSES = {
    "rgb_loss": lambda L, a, b, d1, d2, m: L.rgb_loss(a, b, None, 0.2),
    "rgb_loss_masked": lambda L, a, b, d1, d2, m: L.rgb_loss(a, b, m[..., None]),
    "ssim": lambda L, a, b, d1, d2, m: L.ssim(a, b),
    "depth_l1": lambda L, a, b, d1, d2, m: L.depth_l1(d1, d2, m),
    "depth_mse": lambda L, a, b, d1, d2, m: L.depth_mse(d1, d2, m),
    "depth_logl1": lambda L, a, b, d1, d2, m: L.depth_logl1(d1, d2, m),
    "depth_huberl1": lambda L, a, b, d1, d2, m: L.depth_huberl1(d1, d2, m),
    "edge_aware_logl1": lambda L, a, b, d1, d2, m: L.depth_edge_aware_logl1(
        d1, d2, a, m),
    "tv": lambda L, a, b, d1, d2, m: L.tv_loss(a, m),
    "edge_aware_tv": lambda L, a, b, d1, d2, m: L.edge_aware_tv(d1, a),
    "normal_l1": lambda L, a, b, d1, d2, m: L.normal_l1(a - 0.5, b - 0.5, m),
    "normal_cosine": lambda L, a, b, d1, d2, m: L.normal_cosine(a - 0.5, b - 0.5),
    "flatness": lambda L, a, b, d1, d2, m: L.flatness_loss(
        a[0] - 3.0, m[0] > 0.5),
    "entropy": lambda L, a, b, d1, d2, m: L.opacity_entropy_loss(
        4 * a[0, :, 0] - 2, m[0] > 0.5),
    "touch_normal": lambda L, a, b, d1, d2, m: L.touch_normal_loss(
        a[0], b[0], m[0] > 0.5),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    arrs = _imgs(1)
    lj = LOSSES[name](LJ, *[jnp.asarray(x) for x in arrs])
    lt = LOSSES[name](LT, *[torch.tensor(x) for x in arrs])
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-7)


def test_normals_from_depth_match_jax(fixture):
    cams_j = fixture[0]
    cams_t = SYNT.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0,
                               device="cpu")
    d = fixture[1]["sensor_depths"][0] + 1.0
    nj = LJ.normals_from_depth(jnp.asarray(d), cams_j.index(0))
    nt = LT.normals_from_depth(torch.tensor(d), cams_t.index(0))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-4)


# ----------------------------------------------------- init / optim / adc --

def test_init_from_points_matches_jax(fixture):
    _, _, init, pts2, nrm2 = fixture
    st = init_t(torch.tensor(pts2), torch.full((150, 3), 0.5), capacity=2048,
                sh_degree=3, seed_normals=torch.tensor(nrm2))
    for k, v in st.fields().items():
        np.testing.assert_allclose(v.numpy(), init[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(knn_t(torch.tensor(pts2), chunk=64).numpy(),
                               np.exp(init["log_scales"][:150, 0]), rtol=1e-5)


def _params(seed, n=64):
    rng = np.random.RandomState(seed)
    return {"means": rng.normal(size=(n, 3)).astype(np.float32),
            "features_dc": rng.normal(size=(n, 3)).astype(np.float32),
            "logit_opacities": rng.normal(size=(n,)).astype(np.float32)}


def test_adam_step_matches_jax():
    groups = {"means": OJ.GroupSpec(1.6e-4, 1.6e-6, 100),
              "features_dc": OJ.GroupSpec(2.5e-3, every_k=3),
              "logit_opacities": OJ.GroupSpec(5e-2)}
    groups_t = {k: OT.GroupSpec(**dataclasses.asdict(v)) for k, v in groups.items()}
    p = _params(0)
    alive = np.random.RandomState(1).uniform(size=64) > 0.2
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.tensor(v) for k, v in p.items()}
    sj, st = OJ.init_adam(pj), OT.init_adam(pt)
    for step in range(7):
        g = _params(10 + step)
        pj, sj = OJ.adam_step(pj, {k: jnp.asarray(v) for k, v in g.items()},
                              sj, jnp.int32(step), jnp.asarray(alive),
                              groups=groups)
        pt, st = OT.adam_step(pt, {k: torch.tensor(v) for k, v in g.items()},
                              st, step, torch.tensor(alive), groups=groups_t)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
        for tree in ("m", "v", "acc"):
            np.testing.assert_allclose(getattr(st, tree)[k].numpy(),
                                       np.asarray(getattr(sj, tree)[k]),
                                       atol=1e-7, rtol=1e-5)
        assert int(st.counts[k]) == int(sj.counts[k])


def test_accumulate_stats_and_compaction_match_jax():
    rng = np.random.RandomState(2)
    n = 96
    grad = rng.normal(size=(n, 2)).astype(np.float32)
    radius = np.where(rng.uniform(size=n) > 0.4, rng.uniform(1, 9, n), 0.0)
    radius = radius.astype(np.float32)
    sj = ADCJ.accumulate_stats(ADCJ.init_stats(n), jnp.asarray(grad),
                               jnp.asarray(radius), W, H)
    stt = ADCT.accumulate_stats(ADCT.init_stats(n, "cpu"), torch.tensor(grad),
                                torch.tensor(radius), W, H)
    for k, v in stt.fields().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(sj, k)),
                                   rtol=1e-6, err_msg=k)

    from fusionsense_tpu.gaussians.store import new_state as new_j

    g_j = new_j(n, 3).replace(
        means=jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32)),
        alive=jnp.asarray(rng.uniform(size=n) > 0.5))
    o_j = OJ.init_adam(g_j.params())
    o_j = o_j.replace(m={**o_j.m, "means": g_j.means * 2})
    g_t = convert.state_from_numpy(_np_tree(g_j), "cpu")
    o_t = convert.adam_from_numpy(
        {"m": _np_tree(o_j.m), "v": _np_tree(o_j.v), "acc": _np_tree(o_j.acc),
         "counts": _np_tree(o_j.counts)}, "cpu")
    gj2, oj2, sj2 = RSJ.compact_train_state(g_j, o_j, sj)
    gt2, ot2, st2 = RST.compact_train_state(g_t, o_t, stt)
    for k, v in gt2.fields().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(gj2, k)))
    np.testing.assert_array_equal(ot2.m["means"].numpy(),
                                  np.asarray(oj2.m["means"]))
    np.testing.assert_allclose(st2.grad2d_acc.numpy(),
                               np.asarray(sj2.grad2d_acc), rtol=1e-6)
    for cap in (64, 192):
        gj3, _, _ = RSJ.resize_train_state(gj2, oj2, sj2, new_capacity=cap)
        gt3, _, _ = RST.resize_train_state(gt2, ot2, st2, new_capacity=cap)
        np.testing.assert_array_equal(gt3.alive.numpy(), np.asarray(gj3.alive))
        np.testing.assert_array_equal(gt3.means.numpy(), np.asarray(gj3.means))


def test_cameras_and_stats_carry_across(fixture):
    """JAX cameras and refine stats, fetched as numpy, continue in the port."""
    cams_j = fixture[0]
    keys = ("viewmat", "fx", "fy", "cx", "cy")
    cam_t = convert.camera_from_numpy(
        {**{k: np.asarray(getattr(cams_j, k)) for k in keys},
         "width": cams_j.width, "height": cams_j.height}, "cpu")
    ring_t = SYNT.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0,
                               device="cpu")
    assert (cam_t.width, cam_t.height) == (ring_t.width, ring_t.height)
    for k in keys:
        np.testing.assert_allclose(getattr(cam_t, k).numpy(),
                                   getattr(ring_t, k).numpy(), atol=1e-6)
    for i in range(V):
        np.testing.assert_allclose(cam_t.index(i).origin.numpy(),
                                   np.asarray(cams_j.index(i).origin), atol=1e-6)

    rng = np.random.RandomState(3)
    n = 64
    grads = rng.normal(size=(2, n, 2)).astype(np.float32)
    radii = np.where(rng.uniform(size=(2, n)) > 0.4,
                     rng.uniform(1, 9, (2, n)), 0.0).astype(np.float32)
    sj = ADCJ.init_stats(n)
    for g, r in zip(grads, radii):
        sj = ADCJ.accumulate_stats(sj, jnp.asarray(g), jnp.asarray(r), W, H)
    sj1 = ADCJ.accumulate_stats(ADCJ.init_stats(n), jnp.asarray(grads[0]),
                                jnp.asarray(radii[0]), W, H)
    st = ADCT.accumulate_stats(convert.stats_from_numpy(_np_tree(sj1), "cpu"),
                               torch.tensor(grads[1]), torch.tensor(radii[1]),
                               W, H)
    assert st.count.dtype == torch.int32
    for k, v in st.fields().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(sj, k)),
                                   rtol=1e-6, err_msg=k)


# ---------------------------------------------------------- step body ------

def test_step_losses_and_gradients_match_jax(fixture):
    cams_j, data_j, st_j = _jax_side(fixture)
    cams_t, data_t, st_t = _torch_side(fixture)
    cfg_j, cfg_t = _cfg(CFJ, RCJ), _cfg(CFT, RCT)
    cam_idx, step = 1, 0
    cap = st_j.capacity

    def loss_j(params, tap, abs_tap):
        return TRJ.compute_losses(st_j.replace(**params), cams_j, data_j,
                                  cam_idx, step, cfg_j, tap,
                                  absgrad_tap=abs_tap)

    tap0 = jnp.zeros((cap, 2))
    (lj, (parts_j, _)), gj = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(st_j.params(), tap0, tap0)

    params = {k: v.clone().requires_grad_(True)
              for k, v in st_t.params().items()}
    tap = torch.zeros((cap, 2), requires_grad=True)
    abst = torch.zeros((cap, 2), requires_grad=True)
    lt, (parts_t, _) = TRT.compute_losses(st_t.replace(**params), cams_t,
                                          data_t, cam_idx, step, cfg_t, tap,
                                          absgrad_tap=abst)
    keys = list(params)
    gt = torch.autograd.grad(lt, [params[k] for k in keys] + [tap, abst],
                             allow_unused=True)

    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    assert set(parts_t) == set(parts_j)
    for k in parts_j:
        np.testing.assert_allclose(float(parts_t[k].detach()), float(parts_j[k]),
                                   rtol=1e-4, err_msg=k)
    want = [gj[0][k] for k in keys] + [gj[1], gj[2]]
    for name, a, b in zip(keys + ["tap", "absgrad_tap"], gt, want):
        a = np.zeros(b.shape, np.float32) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=2e-2,
                                   err_msg=name)


# the ADC schedule of the run tests: refines at steps 4, 8 and 12, the
# opacity reset at 12; splits (big on screen or in the world) and dups both
ADC_KW = dict(warmup=4, refine_every=4, reset_alpha_every=2,
              stop_split_at=100, densify_grad_thresh=5e-4,
              densify_size_thresh=0.14, split_screen_size=0.27,
              cull_alpha_thresh=0.09)


def _with(cfg, mod, adc=None, **train_kw):
    """cfg with the ADC schedule (the package's ADCConfig) and train fields."""
    adc_cls = ADCJ.ADCConfig if mod is CFJ else ADCT.ADCConfig
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, adc=adc_cls(**(adc or ADC_KW)), **train_kw))


@pytest.fixture
def jax_split_noise(monkeypatch):
    """The port's trainer draws JAX's split normals: the generator's seed is
    the JAX trainer's per-step seed, so the same PRNG key is rebuilt."""
    def noise(generator, n, capacity, device=None):
        key = jax.random.PRNGKey(np.uint32(generator.initial_seed()))
        keys = jax.random.split(key, max(n, 2))
        return torch.tensor(np.stack([np.asarray(jax.random.normal(
            k, (capacity, 3))) for k in keys]), device=device)
    monkeypatch.setattr(TRT, "split_noise", noise)


def _runs_match(fixture, backend, train_kw=None, callbacks=(None, None),
                boundaries=(4, 8, 12)):
    """Both trainers through the same boundaries (refines at 4, 8, 12):
    after each, the population, capacity bucket, render prefix, K / pair
    budget and cover window exactly, the logged loss within rtol 2e-3."""
    cams_j, data_j, st_j = _jax_side(fixture)
    cams_t, data_t, st_t = _torch_side(fixture)
    train_kw = train_kw or {}
    tr_j = TRJ.Trainer(_with(_cfg(CFJ, RCJ, backend), CFJ, **train_kw),
                       cams_j, data_j, st_j,
                       extra_callbacks=[c for c in callbacks[:1] if c])
    tr_t = TRT.Trainer(_with(_cfg(CFT, RCT, backend), CFT, **train_kw),
                       cams_t, data_t, st_t,
                       extra_callbacks=[c for c in callbacks[1:] if c],
                       device="cpu")
    for b in boundaries:
        tr_j.run(iterations=b, log=None)
        tr_t.run(iterations=b, log=None)
        rj, rt = tr_j.history[-1], tr_t.history[-1]
        assert rt["step"] == rj["step"] == b
        np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=2e-3)
        assert rt["nonfinite_steps"] == rj["nonfinite_steps"] == 0
        for k in ("num_gaussians", "capacity", "tile_overflow"):
            assert rt[k] == rj[k], (b, k, rt[k], rj[k])
        assert (tr_t.render_n, tr_t.tile_capacity, tr_t.cover_tiles) == (
            tr_j.render_n, tr_j.tile_capacity, tr_j.cover_tiles), b
    # the refines grew the population
    assert tr_t.history[-1]["num_gaussians"] > 150
    agree, total = 0, 0
    for k, v in tr_t.gaussians.params().items():
        a, b = v.numpy(), np.asarray(getattr(tr_j.gaussians, k))
        agree += np.sum(np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b))
        total += a.size
    assert agree / total >= 0.999, agree / total
    return tr_t, tr_j


def test_trainer_run_matches_jax(fixture, jax_split_noise):
    _runs_match(fixture, "flat")


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_dense_trainer_run_matches_jax(fixture, jax_split_noise, backend):
    """12 steps with bin_refresh_steps > 0 left in the config, which the
    dense trainer ignores in both packages, through three refines. The
    fixture's dead slots pile into the centre tiles, so the K ladder fires
    at the log boundaries in both."""
    tr_t, _ = _runs_match(fixture, backend)
    assert tr_t.tile_capacity > RKW["tile_capacity"]


def test_tile_capacity_ladder_matches_jax(fixture):
    """The dense K ladder and the flat pair-budget policy, step by step: a
    ladder fires only on dense backends, by 1.5x rounded up to 128, when
    overflow exceeds tile_overflow_frac * T * K, and stops at the cap."""
    cams_j, data_j, st_j = _jax_side(fixture)
    cams_t, data_t, st_t = _torch_side(fixture)
    for backend in ("jax", "pallas", "flat"):
        tr_j = TRJ.Trainer(_cfg(CFJ, RCJ, backend), cams_j, data_j, st_j)
        tr_t = TRT.Trainer(_cfg(CFT, RCT, backend), cams_t, data_t, st_t,
                           device="cpu")
        for overflow, used in ((0, 0), (30, 0), (31, 2000), (10_000, 9000),
                               (10_000, 0), (10 ** 6, 40_000), (10 ** 6, 0),
                               (10 ** 6, 100)):
            for tr in (tr_j, tr_t):
                tr._maybe_bump_tile_capacity(overflow)
                tr._maybe_resize_pair_budget(used)
            assert tr_t.tile_capacity == tr_j.tile_capacity, (backend, overflow)
        want = 2048 if backend != "flat" else tr_j.tile_capacity
        assert tr_t.tile_capacity == want


@pytest.mark.parametrize("name", ["splatfacto", "dn-splatter",
                                  "dn-splatter-big", "fusionsense"])
@pytest.mark.parametrize("backend", ["jax", "pallas", "flat"])
def test_presets_match_jax(name, backend):
    from fusionsense_tpu import presets as PJ
    from fusionsense_tpu_torch import presets as PT

    assert set(PT.PRESETS) == set(PJ.PRESETS)
    assert dataclasses.asdict(PT.PRESETS[name](backend)) == dataclasses.asdict(
        PJ.PRESETS[name](backend))


def test_touch_callback_run_matches_jax(fixture, jax_split_noise):
    """Touch patches anchored by a callback at the step-8 boundary (after
    that refine), touch_prune at every later boundary, in both packages."""
    from fusionsense_tpu.gaussians import touch as TJ
    from fusionsense_tpu_torch.gaussians import touch as TT

    patches_j = SYNJ.sphere_touch_patches(n_patches=2, pts_per_patch=60)
    patches_t = SYNT.sphere_touch_patches(n_patches=2, pts_per_patch=60)

    def touch_cb(mod, patches):
        boxes = []

        def cb(tr):
            if not boxes and tr.step >= tr.cfg.train.add_touch_at:
                tr.gaussians, tr.opt, box = mod.add_touch_patches(
                    tr.gaussians, tr.opt, patches, gel_scale=0.01)
                boxes.append(box)
                return True
            if boxes:
                tr.gaussians = mod.touch_prune(tr.gaussians, boxes[0])
            return False
        return cb

    tr_t, tr_j = _runs_match(
        fixture, "pallas", train_kw={"add_touch_at": 8},
        callbacks=(touch_cb(TJ, patches_j), touch_cb(TT, patches_t)))
    frz_t = int((tr_t.gaussians.frozen & tr_t.gaussians.alive).sum())
    frz_j = int(np.sum(np.asarray(tr_j.gaussians.frozen & tr_j.gaussians.alive)))
    assert frz_t == frz_j == 120


def test_camera_opt_run_matches_jax(fixture, jax_split_noise):
    """Camera optimisation on the flat backend (the bin cache projects with
    the pose deltas) with the deltas' Adam stepping every 2 steps."""
    tr_t, tr_j = _runs_match(fixture, "flat", train_kw={
        "camera_opt": True, "camera_opt_every_k": 2})
    d_t = tr_t.cam_state[0].numpy()
    d_j = np.asarray(tr_j.cam_state[0])
    np.testing.assert_allclose(d_t, d_j, atol=1e-5, rtol=0)
    assert np.abs(d_t).max() > 1e-4
    for tree in ("m", "v"):
        np.testing.assert_allclose(
            getattr(tr_t.cam_state[1], tree)["cam_delta"].numpy(),
            np.asarray(getattr(tr_j.cam_state[1], tree)["cam_delta"]),
            atol=1e-6, rtol=1e-3)
    assert int(tr_t.cam_state[1].counts["cam_delta"]) == 6


def test_sdf_loss_matches_jax(fixture):
    """The SDF loss and its gradients with the samples passed in: JAX's
    own draw for its key goes into the port's sdf_loss."""
    from fusionsense_tpu.train import sdf_loss as SDJ
    from fusionsense_tpu_torch.train import sdf_loss as SDT

    cams_j = fixture[0]
    cams_t = SYNT.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0,
                               device="cpu")
    init = fixture[2]
    rng = np.random.RandomState(5)
    depth = (fixture[1]["sensor_depths"][1]
             + 0.05 * rng.normal(size=(H, W))).astype(np.float32)
    alive = init["alive"].copy()
    alive[:10] = False
    args = [init["means"], init["quats"], np.exp(init["log_scales"]),
            1.0 / (1.0 + np.exp(-init["logit_opacities"]))]
    key = jax.random.PRNGKey(3)
    pts, idx = SDJ.sample_points_in_gaussians(
        key, *[jnp.asarray(a) for a in args[:3]], jnp.asarray(alive), 256)
    assert np.asarray(alive)[np.asarray(idx)].all()

    def loss_j(m, q, sc, o):
        return SDJ.sdf_loss(key, m, q, sc, o, jnp.asarray(alive),
                            jnp.asarray(depth), cams_j.index(1), n_samples=256)

    lj, gj = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    lt = SDT.sdf_loss(torch.tensor(np.asarray(pts)), *leaves,
                      torch.tensor(alive), torch.tensor(depth), cams_t.index(1))
    gt = torch.autograd.grad(lt, leaves)
    assert float(lj) > 0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    for name, a, b in zip(("means", "quats", "scales", "opacities"), gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=2e-2, err_msg=name)
        assert np.abs(np.asarray(b)).max() > 0, name

    gen = torch.Generator().manual_seed(3)
    p1, i1 = SDT.sample_points_in_gaussians(
        gen, *[torch.tensor(a) for a in args[:3]], torch.tensor(alive), 256)
    p2, i2 = SDT.sample_points_in_gaussians(
        torch.Generator().manual_seed(3), *[torch.tensor(a) for a in args[:3]],
        torch.tensor(alive), 256)
    assert p1.shape == (256, 3) and i1.shape == (256,)
    assert torch.equal(p1, p2) and torch.equal(i1, i2)
    assert bool(torch.tensor(alive)[i1].all())


def test_sdf_and_camera_opt_train(fixture):
    """The trainer with sdf_lambda > 0 and camera optimisation on every
    backend: finite losses, the sdf term in the loss, moving deltas."""
    cams_t, data_t, st_t = _torch_side(fixture)
    cfg = _cfg(CFT, RCT)
    cfg = dataclasses.replace(
        cfg, loss=dataclasses.replace(cfg.loss, sdf_lambda=0.1, sdf_samples=128),
        train=dataclasses.replace(cfg.train, camera_opt=True,
                                  camera_opt_every_k=2))
    for backend in ("flat", "jax", "pallas"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, rasterize=dataclasses.replace(cfg.model.rasterize,
                                                     backend=backend)))
        tr = TRT.Trainer(c, cams_t, data_t, st_t, device="cpu")
        hist = tr.run(iterations=4, log=None)
        assert np.isfinite(hist[-1]["loss"]) and hist[-1]["nonfinite_steps"] == 0
        assert float(tr.cam_state[0].abs().max()) > 0
    cam = cams_t.index(0)
    tap = torch.zeros((st_t.capacity, 2))
    _, (parts, _) = TRT.compute_losses(st_t, cams_t, data_t, 0, 7, c, tap)
    assert float(parts["sdf"]) > 0
    g = torch.Generator().manual_seed(7)
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.train import sdf_loss as SDT

    m, q, sc, o, _ = activated(st_t)
    pts, _ = SDT.sample_points_in_gaussians(g, m, q, sc, st_t.alive, 128)
    out_depth = TRT.R.rasterize(*activated(st_t), cam, c.model.rasterize,
                                device="cpu").depth
    torch.testing.assert_close(parts["sdf"], SDT.sdf_loss(
        pts, m, q, sc, o, st_t.alive, out_depth, cam))


def test_off_slice_options_raise(fixture):
    """What is left unported raises, naming its ROADMAP item."""
    cams_t, data_t, st_t = _torch_side(fixture)
    cfg = _cfg(CFT, RCT)
    bf16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rasterize=dataclasses.replace(cfg.model.rasterize,
                                                 blend_bf16=True)))
    with pytest.raises(NotImplementedError, match="N5"):
        TRT.Trainer(bf16, cams_t, data_t, st_t, device="cpu")
