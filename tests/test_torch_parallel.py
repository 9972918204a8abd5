"""The port's multi-device step (fusionsense_tpu_torch/parallel/) against
JAX's make_sharded_train_step, on tests/test_parallel.py's scene and at its
tolerances: the same numpy inputs go through JAX's step on the 8-device
virtual CPU mesh and through the port's step in 8 gloo ranks (one world of
processes for the module, tests/torch_parallel_world.py), and the port's
step is also held against its own single-device batch-mean step. Each test
mirrors the test of tests/test_parallel.py with its name."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_cases as CASES
from fusionsense_tpu import config as CFJ
from fusionsense_tpu.data.synthetic import (
    ring_cameras, sphere_depth_normals, sphere_points,
)
from fusionsense_tpu.gaussians.adc import init_stats
from fusionsense_tpu.gaussians.init import init_from_points
from fusionsense_tpu.gaussians.store import activated
from fusionsense_tpu.parallel.mesh import make_mesh
from fusionsense_tpu.parallel.sharded import make_sharded_train_step
from fusionsense_tpu.render.rasterize import RasterizeConfig, rasterize
from fusionsense_tpu.train.optim import init_adam
from fusionsense_tpu.train.trainer import TrainData
from fusionsense_tpu_torch import config as CFT
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from torch_parallel_world import World

RKW = dict(tile_size=16, tile_capacity=64, max_tiles_per_gaussian=8,
           tile_chunk=4, sh_degree=1)
TOL = dict(atol=2e-5, rtol=1e-3)        # test_parallel.py's, by test
TOL_Z1 = dict(atol=3e-5, rtol=1e-3)
TOL_SLICE = dict(atol=4e-4, rtol=1e-3)
TOL_SLICE_M = dict(atol=4e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def scene():
    """test_parallel.py's scene, and its numpy copy for the port."""
    cams = ring_cameras(n_views=4, width=64, height_px=48, focal=60.0)
    pts, rgb, normals = sphere_points(n=200, radius=0.5)
    gt = init_from_points(pts, rgb, capacity=256, sh_degree=1,
                          seed_normals=normals, init_opacity=0.9)
    rcfg = RasterizeConfig(**RKW)
    m, q, s, o, c = activated(gt)
    imgs, deps, nms = [], [], []
    for i in range(4):
        out = rasterize(m, q, s, o, c, cams.index(i), rcfg)
        imgs.append(out.rgb)
        d, n, _ = sphere_depth_normals(cams.index(i))
        deps.append(d)
        nms.append(n)
    data = TrainData(images=jnp.stack(imgs), sensor_depths=jnp.stack(deps),
                     normals=jnp.stack(nms))
    np_scene = {
        "camera": {**{k: np.asarray(getattr(cams, k))
                      for k in ("viewmat", "fx", "fy", "cx", "cy")},
                   "width": 64, "height": 48},
        "data": {k: np.asarray(getattr(data, k))
                 for k in ("images", "sensor_depths", "normals")}}
    return cams, data, np_scene


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(8, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _cfgs(train=None, **rkw):
    """test_parallel.make_cfg in both packages; `train` overrides fields of
    its TrainConfig."""
    def make(mod, rc):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(sh_degree=1, rasterize=rc(**dict(RKW, **rkw)),
                                  capacity=256, binary_opacities=False),
            train=mod.TrainConfig(**{"iterations": 10, "scan_chunk": 5,
                                     **(train or {})}),
            loss=mod.LossConfig(normal_lambda=0.1, sensor_depth_lambda=0.2,
                                smooth_lambda=0.01, flatness_lambda=0.01))
    return make(CFJ, RasterizeConfig), make(CFT, RCT)


def _init(n):
    pts, rgb, _ = sphere_points(n=n, radius=0.5)
    g = init_from_points(pts, rgb, capacity=256, sh_degree=1)
    return g, {k: np.asarray(v) for k, v in dataclasses.asdict(g).items()}


_JAX_STEPS = {}


def _jax_step(scene, cfg, axes, g, cam_indices, zero=False):
    """JAX's sharded step (one jitted function per configuration, reused
    across tests) -> numpy params, first moments, stats and metrics."""
    cams, data, _ = scene
    key = (repr(cfg), tuple(sorted(axes.items())), zero)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = make_sharded_train_step(
            cfg, cams, data, make_mesh(8, **axes), shard_optimizer=zero)
    nv = data.images.shape[0]
    cam_state = (jnp.zeros((nv, 6)), init_adam({"cam_delta": jnp.zeros((nv, 6))}))
    g2, opt2, _, st2, m = _JAX_STEPS[key](
        g, init_adam(g.params()), cam_state, init_stats(256), jnp.asarray(0),
        jnp.asarray(cam_indices, jnp.int32))
    return {"params": {k: np.asarray(v) for k, v in g2.params().items()},
            "m": {k: np.asarray(v) for k, v in opt2.m.items()},
            "stats": {k: np.asarray(v) for k, v in dataclasses.asdict(st2).items()},
            "metrics": {k: np.asarray(v) for k, v in m.items()}}


def _port_step(world, scene, cfg, axes, init, cam_indices, zero=False,
               reference=False):
    """The port's step on every rank; all ranks must hold the same state."""
    res = world.run(CASES.sharded_step, scene=scene[2], cfg=cfg, axes=axes,
                    init=init, cam_indices=list(cam_indices),
                    shard_optimizer=zero, reference=reference)
    for r in res[1:]:
        for part in ("params", "m", "v", "stats"):
            for k, v in res[0][part].items():
                np.testing.assert_array_equal(r[part][k], v, err_msg=k)
    return res[0]


def _assert_update(a, b, tol, tol_m=None, keys=("means", "features_dc")):
    for k in keys:
        np.testing.assert_allclose(a["params"][k], b["params"][k], **tol,
                                   err_msg=k)
    # the moments hold the gradient SCALE (Adam's step at t = 1 does not)
    np.testing.assert_allclose(a["m"]["means"], b["m"]["means"],
                               **(tol_m or tol))


def test_sharded_step_runs_and_reduces(scene, world):
    cfg_j, cfg_t = _cfgs()
    g, init = _init(100)
    got = _port_step(world, scene, cfg_t, dict(data=4, tile=2), init, range(4))
    assert np.isfinite(got["metrics"]["loss"])
    assert not np.allclose(got["params"]["means"][:100], init["means"][:100])
    assert got["stats"]["count"].sum() > 0
    _assert_update(got, _jax_step(scene, cfg_j, dict(data=4, tile=2), g,
                                  range(4)), TOL)


def test_sharded_matches_single_device_grads(scene, world):
    """data x tile sharding gives the single-device batch-mean update, and
    JAX's sharded update."""
    cfg_j, cfg_t = _cfgs()
    g, init = _init(80)
    got = _port_step(world, scene, cfg_t, dict(data=4, tile=2), init,
                     range(4), reference=True)
    _assert_update(got, got["ref"], TOL)
    _assert_update(got, _jax_step(scene, cfg_j, dict(data=4, tile=2), g,
                                  range(4)), TOL)


def test_zero1_sharded_optimizer_matches(scene, world):
    """ZeRO-1 gives the replicated update; its moments, gathered, the
    replicated moments; and JAX's ZeRO-1 update."""
    cfg_j, cfg_t = _cfgs()
    g, init = _init(80)
    axes = dict(data=4, tile=2)
    rep = _port_step(world, scene, cfg_t, axes, init, range(4))
    z1 = _port_step(world, scene, cfg_t, axes, init, range(4), zero=True)
    _assert_update(z1, rep, TOL_Z1)
    _assert_update(z1, _jax_step(scene, cfg_j, axes, g, range(4), zero=True),
                   TOL_Z1)


def test_gauss_depth_sliced_matches_single_device(scene, world):
    """data x tile x gauss (2x2x2): the depth-slice merge reproduces the
    single-device update and gradient scale, and JAX's sharded update (the
    atol is test_parallel.py's: association-order noise in the merged
    alpha, amplified by the expected-depth division at low alpha)."""
    cfg_j, cfg_t = _cfgs()
    g, init = _init(80)
    axes = dict(data=2, tile=2, gauss=2)
    got = _port_step(world, scene, cfg_t, axes, init, range(2),
                     reference=True)
    _assert_update(got, got["ref"], TOL_SLICE, TOL_SLICE_M, keys=("means",))
    _assert_update(got, _jax_step(scene, cfg_j, axes, g, range(2)),
                   TOL_SLICE, TOL_SLICE_M, keys=("means",))


def test_sharded_pallas_backend_matches_jax_backend(scene, world):
    """The pallas backend (K3/K4's plain versions at the block's global
    tile ids) gives the plain compositor's update, and JAX's pallas
    update."""
    cfg_j, cfg_t = _cfgs(backend="pallas", pallas_chunk=64)
    _, cfg_t_jax = _cfgs()
    g, init = _init(80)
    axes = dict(data=4, tile=2)
    got = _port_step(world, scene, cfg_t, axes, init, range(4))
    plain = _port_step(world, scene, cfg_t_jax, axes, init, range(4))
    assert np.isfinite(got["metrics"]["loss"])
    np.testing.assert_allclose(got["metrics"]["loss"],
                               plain["metrics"]["loss"], rtol=1e-4)
    _assert_update(got, plain, TOL_Z1, keys=("means",))
    _assert_update(got, _jax_step(scene, cfg_j, axes, g, range(4)), TOL_Z1,
                   keys=("means",))
    assert "overflow" in got["metrics"]


def test_sharded_flat_backend_matches_jax_backend(scene, world):
    """The flat backend (K1/K2's plain versions over the block's local
    layout at tile_lo) gives the plain compositor's update at a K that
    drops nothing, and JAX's flat update."""
    cfg_j, cfg_t = _cfgs(backend="flat", pallas_chunk=64, tile_capacity=128)
    _, cfg_t_jax = _cfgs(tile_capacity=256)
    g, init = _init(80)
    axes = dict(data=4, tile=2)
    got = _port_step(world, scene, cfg_t, axes, init, range(4))
    plain = _port_step(world, scene, cfg_t_jax, axes, init, range(4))
    assert np.isfinite(got["metrics"]["loss"])
    np.testing.assert_allclose(got["metrics"]["loss"],
                               plain["metrics"]["loss"], rtol=1e-4)
    _assert_update(got, plain, TOL_Z1, keys=("means",))
    _assert_update(got, _jax_step(scene, cfg_j, axes, g, range(4)), TOL_Z1,
                   keys=("means",))


def test_sharded_flat_absgrad_stats_match_single_device(scene, world):
    """data=1 x tile=4 x gauss=2 on the flat backend: the absgrad
    accumulator equals the single-device step's, and JAX's sharded one."""
    cfg_j, cfg_t = _cfgs(backend="flat", pallas_chunk=64, tile_capacity=128)
    g, init = _init(80)
    axes = dict(data=1, tile=4, gauss=2)
    got = _port_step(world, scene, cfg_t, axes, init, [0])
    single = world.run(CASES.single_step_stats, scene=scene[2], cfg=cfg_t,
                       init=init, view=0)[0]
    acc = got["stats"]["grad2d_acc"]
    assert acc.sum() > 0
    np.testing.assert_allclose(acc, single["grad2d_acc"], atol=1e-5,
                               rtol=2e-2)
    np.testing.assert_allclose(
        acc, _jax_step(scene, cfg_j, axes, g, [0])["stats"]["grad2d_acc"],
        atol=1e-5, rtol=2e-2)


def test_sharded_trainer_run_matches_jax(scene, world):
    """JAX's ShardedTrainer and the port's on the same init, 2 x 2 x 2 with
    ZeRO-1 on the flat backend: 12 steps in chunks of 4 with refines at 4
    and 8 (their split normals JAX's draws, as the refine seeds them), the
    render prefix and the auto K / pair budget / cover window on. After the
    run the history, the population, render_n, the pair budget, the cover
    window, the params and the moments gathered over `data` agree."""
    from fusionsense_tpu.gaussians.adc import ADCConfig as ADCJ
    from fusionsense_tpu.parallel.trainer import ShardedTrainer as STJ
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig as ADCT

    adc = dict(warmup=4, refine_every=4, stop_split_at=12,
               reset_alpha_every=10_000, densify_grad_thresh=1e-4)
    train = dict(iterations=12, scan_chunk=4, log_every=4,
                 auto_capacity=False)
    cfg_j, cfg_t = _cfgs(train=train, backend="flat", pallas_chunk=64,
                         tile_capacity=128)
    cfg_j = dataclasses.replace(cfg_j, train=dataclasses.replace(
        cfg_j.train, adc=ADCJ(**adc)))
    cfg_t = dataclasses.replace(cfg_t, train=dataclasses.replace(
        cfg_t.train, adc=ADCT(**adc)))
    g, init = _init(150)
    noise = {}
    for step in (4, 8):
        seed = (cfg_t.train.seed * 1_000_003 + step) % (1 << 32)
        keys = jax.random.split(jax.random.PRNGKey(np.uint32(seed)),
                                max(cfg_t.train.adc.n_split_samples, 2))
        noise[seed] = np.stack([np.asarray(jax.random.normal(k, (256, 3)))
                                for k in keys])
    axes = dict(data=2, tile=2, gauss=2)
    cams, data, np_scene = scene
    tj = STJ(cfg_j, cams, data, g, make_mesh(8, **axes), shard_optimizer=True)
    hist_j = tj.run(log=None)
    res = world.run(CASES.sharded_trainer, scene=np_scene, cfg=cfg_t,
                    axes=axes, init=init, noise=noise)
    for r in res[1:]:
        for k, v in res[0]["bytes"].items():
            assert r["bytes"][k] == v, k
    got = res[0]
    hist_t = got["history"]
    assert [h["step"] for h in hist_t] == [h["step"] for h in hist_j] \
        == [4, 8, 12]
    for ht, hj in zip(hist_t, hist_j):
        for k in ("num_gaussians", "capacity", "tile_overflow",
                  "nonfinite_steps"):
            assert ht[k] == hj[k], (ht["step"], k, ht[k], hj[k])
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=2e-3)
        np.testing.assert_allclose(ht["psnr"], hj["psnr"], rtol=1e-3)
    assert got["num_alive"] == int(tj.gaussians.num_alive) != 150
    assert got["render_n"] == tj.render_n
    assert got["tile_capacity"] == tj.tile_capacity
    assert got["cover_tiles"] == tj.cover_tiles
    for k in ("means", "features_dc"):
        np.testing.assert_allclose(got["params"][k],
                                   np.asarray(tj.gaussians.params()[k]),
                                   **TOL_SLICE, err_msg=k)
    # the moments against their largest entry (read at 1.7e-4 of it for
    # m.means and 4.4e-5 for v.means)
    for part in ("m", "v"):
        for k in ("means", "features_dc"):
            ref = np.asarray(getattr(tj.opt, part)[k])
            d = np.abs(got[part][k] - ref).max()
            assert d <= 2e-3 * np.abs(ref).max(), (part, k, d)
