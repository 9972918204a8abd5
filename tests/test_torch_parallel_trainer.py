"""The port's ShardedTrainer (fusionsense_tpu_torch/parallel/trainer.py), its
checkpoints and fs-train --device-mesh, in gloo ranks on the CPU (one world
of 8 processes for the module, another of 2 for the pipeline). Each of the
first four tests mirrors the test of tests/test_parallel.py with its name,
on the same scene built by the port (its JAX twin is held to JAX's in
test_torch_parallel.py and test_torch_train.py): the sharded run against
the single-device Trainer. Then the ranks' agreement after refines and
callbacks, and the pipeline on two ranks."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_parallel_cases as CASES
from fusionsense_tpu_torch.config import (
    ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
)
from fusionsense_tpu_torch.data.fixture import write_blob_scene
from fusionsense_tpu_torch.data.synthetic import (
    ring_cameras, sphere_depth_normals, sphere_points,
)
from fusionsense_tpu_torch.gaussians.adc import ADCConfig
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.gaussians.store import activated
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig, rasterize
from torch_parallel_world import World

RCFG = RasterizeConfig(tile_size=16, tile_capacity=64,
                       max_tiles_per_gaussian=8, tile_chunk=4, sh_degree=1)


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops on a shared CPU run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """test_parallel.py's scene (4 ring views at 64x48, a 200-point GT
    sphere rendered through the plain compositor) as numpy."""
    cams = ring_cameras(n_views=4, width=64, height_px=48, focal=60.0,
                        device="cpu")
    pts, rgb, normals = sphere_points(n=200, radius=0.5, device="cpu")
    gt = init_from_points(pts, rgb, capacity=256, sh_degree=1,
                          seed_normals=normals, init_opacity=0.9)
    m, q, s, o, c = activated(gt)
    imgs, deps, nms = [], [], []
    with torch.no_grad():
        for i in range(4):
            imgs.append(rasterize(m, q, s, o, c, cams.index(i), RCFG,
                                  device="cpu").rgb)
            d, n, _ = sphere_depth_normals(cams.index(i))
            deps.append(d)
            nms.append(n)
    return {"camera": {**{k: _np(getattr(cams, k))
                          for k in ("viewmat", "fx", "fy", "cx", "cy")},
                       "width": 64, "height": 48},
            "data": {"images": _np(torch.stack(imgs)),
                     "sensor_depths": _np(torch.stack(deps)),
                     "normals": _np(torch.stack(nms))}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(8, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def make_cfg(rcfg=RCFG, capacity=256, loss=None, **train):
    return ExperimentConfig(
        model=ModelConfig(sh_degree=1, rasterize=rcfg, capacity=capacity,
                          binary_opacities=False),
        train=TrainConfig(**{**dict(iterations=10, scan_chunk=5), **train}),
        loss=loss or LossConfig(normal_lambda=0.1, sensor_depth_lambda=0.2,
                                smooth_lambda=0.01, flatness_lambda=0.01))


def _init(n, capacity, noise=0.0, grey=True):
    pts, rgb, _ = sphere_points(n=n, radius=0.5, device="cpu")
    if noise:
        rng = np.random.RandomState(3)
        pts = pts + torch.as_tensor(
            noise * rng.randn(*pts.shape).astype(np.float32))
    if grey:
        rgb = torch.full_like(rgb, 0.5)
    g = init_from_points(pts, rgb, capacity=capacity, sh_degree=1)
    return {k: _np(v) for k, v in g.fields().items()}


def _ranks_agree(res):
    for r in res[1:]:
        assert r["bytes"].keys() == res[0]["bytes"].keys()
        for k, v in res[0]["bytes"].items():
            assert r["bytes"][k] == v, k


@pytest.mark.slow
def test_sharded_trainer_end_to_end_matches_single_device(scene, world):
    """ZeRO-1 over 4 x 2 ranks with chunks and ADC refines reaches the
    single-device Trainer's PSNR; the refine changed the population."""
    cfg = make_cfg(capacity=512, iterations=500, scan_chunk=50,
                   log_every=100, auto_capacity=False,
                   adc=ADCConfig(warmup=100, refine_every=100,
                                 stop_split_at=400, reset_alpha_every=10_000))
    res = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg,
                    axes=dict(data=4, tile=2), init=_init(150, 512, 0.03),
                    single=True)
    _ranks_agree(res)
    psnr_sh = res[0]["history"][-1]["psnr"]
    psnr_1 = res[0]["single"][-1]["psnr"]
    assert np.isfinite(psnr_sh) and np.isfinite(psnr_1)
    assert psnr_sh > psnr_1 - 0.2, (psnr_sh, psnr_1)
    assert res[0]["num_alive"] != 150


@pytest.mark.slow
def test_sharded_trainer_touch_anchoring_matches_single_device(scene, world):
    """A touch-add callback under the mesh anchors 40 frozen Gaussians and
    the run stays within 0.2 dB of the single-device run."""
    cfg = make_cfg(capacity=512, iterations=300, scan_chunk=50,
                   log_every=100, auto_capacity=False, add_touch_at=100,
                   adc=ADCConfig(warmup=100, refine_every=100,
                                 stop_split_at=250, reset_alpha_every=10_000),
                   loss=LossConfig(normal_lambda=0.1, sensor_depth_lambda=0.2,
                                   smooth_lambda=0.01,
                                   touch_normal_lambda=1.0))
    rng = np.random.RandomState(1)
    ppts = (rng.rand(40, 3) - 0.5) * [0.04, 0.04, 0.004] + [0.0, 0.0, 0.5]
    patch = dict(
        points=ppts.astype(np.float32),
        colors=np.full((40, 3), 0.8, np.float32),
        normals=np.tile([0.0, 0.0, 1.0], (40, 1)).astype(np.float32),
        bbox_center=np.array([0.0, 0.0, 0.5], np.float32),
        bbox_rot=np.eye(3, dtype=np.float32),
        bbox_extent=np.array([0.021, 0.021, 0.003], np.float32))
    res = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg,
                    axes=dict(data=4, tile=2), init=_init(150, 512, 0.03),
                    patches=[patch], single=True)
    _ranks_agree(res)
    assert res[0]["frozen"] == 40
    assert res[0]["frozen_min_op"] > 0.99
    psnr_sh = res[0]["history"][-1]["psnr"]
    psnr_1 = res[0]["single"][-1]["psnr"]
    assert psnr_sh > psnr_1 - 0.2, (psnr_sh, psnr_1)


def test_sharded_trainer_save_restore_roundtrip(scene, world, tmp_path):
    """A ZeRO-1 checkpoint of the mesh restores into the mesh (moments cut
    again) and into the single-device Trainer; both train on."""
    cfg = make_cfg()
    init = _init(100, 256)
    axes = dict(data=4, tile=2)
    ckpt = str(tmp_path / "ckpt_sh")
    first = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg, axes=axes,
                      init=init, iterations=5, save=ckpt)
    second = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg, axes=axes,
                       init=init, restore=ckpt, iterations=10)
    _ranks_agree(second)
    np.testing.assert_array_equal(
        second[0]["restored_means"],
        np.frombuffer(first[0]["bytes"]["g.means"],
                      np.float32).reshape(-1, 3))
    assert second[0]["step"] == 10
    assert np.isfinite(second[0]["history"][-1]["loss"])
    step, hist = world.run(CASES.restore_single, scene=scene, cfg=cfg,
                           init=init, path=ckpt, iterations=10)[0]
    assert step == 5 and np.isfinite(hist[-1]["loss"])


def test_sharded_render_prefix_matches_single_device(scene, world, tmp_path):
    """A capacity-2048 store with 200 alive renders a 1024 prefix under the
    2 x 2 x 2 mesh (the bucket a gauss multiple), tracks the single-device
    prefix trainer, and the prefix survives a checkpoint."""
    cfg = make_cfg(capacity=2048, iterations=40, scan_chunk=20, log_every=20,
                   auto_capacity=False, render_prefix=True,
                   loss=LossConfig(normal_lambda=0.1,
                                   sensor_depth_lambda=0.2))
    init = _init(200, 2048)
    axes = dict(data=2, tile=2, gauss=2)
    ckpt = str(tmp_path / "ckpt_rp")
    res = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg, axes=axes,
                    init=init, save=ckpt, single=True)
    _ranks_agree(res)
    assert res[0]["render_n0"] == 1024 and res[0]["render_n_single"] == 1024
    psnr_sh = res[0]["history"][-1]["psnr"]
    psnr_1 = res[0]["single"][-1]["psnr"]
    assert np.isfinite(psnr_sh) and np.isfinite(psnr_1)
    assert psnr_sh > psnr_1 - 0.2, (psnr_sh, psnr_1)
    again = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg, axes=axes,
                      init=init, restore=ckpt, iterations=40)
    assert again[0]["render_n"] == 1024


@pytest.mark.parametrize("backend", ["flat", "pallas"])
def test_ranks_agree_after_refines_and_callbacks(scene, world, backend):
    """After refines (warmup 4, every 4) and a touch anchoring with its
    recurring prune under ZeRO-1 on 2 x 2 x 2 ranks, every rank holds the
    same store, moments and stats, bit for bit; the refines changed the
    population and the patch is anchored."""
    rc = dataclasses.replace(RCFG, backend=backend, pallas_chunk=64,
                             tile_capacity=128)
    cfg = make_cfg(rc, capacity=512, iterations=12, scan_chunk=4,
                   log_every=4, add_touch_at=4,
                   adc=ADCConfig(warmup=4, refine_every=4, stop_split_at=12,
                                 reset_alpha_every=10_000,
                                 densify_grad_thresh=1e-4))
    rng = np.random.RandomState(2)
    patch = dict(
        points=((rng.rand(20, 3) - 0.5) * [0.04, 0.04, 0.004]
                + [0.0, 0.0, 0.5]).astype(np.float32),
        colors=np.full((20, 3), 0.8, np.float32),
        normals=np.tile([0.0, 0.0, 1.0], (20, 1)).astype(np.float32),
        bbox_center=np.array([0.0, 0.0, 0.5], np.float32),
        bbox_rot=np.eye(3, dtype=np.float32),
        bbox_extent=np.array([0.021, 0.021, 0.003], np.float32))
    res = world.run(CASES.sharded_trainer, scene=scene, cfg=cfg,
                    axes=dict(data=2, tile=2, gauss=2),
                    init=_init(150, 512, 0.03), patches=[patch])
    _ranks_agree(res)
    assert res[0]["step"] == 12
    assert res[0]["num_alive"] not in (150, 170)
    assert res[0]["frozen"] == 20


def _fs_train_two_ranks(root, iterations, masks=True):
    """fs-train --device-mesh data=2 (ZeRO-1) in two gloo ranks on a 64x48
    blob capture (its masks' entries dropped from transforms.json unless
    `masks`), chunks of 4 from a warmup of 4 and a save at the end; each
    rank is given its own output directory. Both ranks must hold the same
    state and history."""
    import json

    scene = root / "scene"
    write_blob_scene(scene, n_views=3, width=64, height=48, focal=55.0,
                     n_gt=800, n_seed_pts=300, device="cpu")
    if not masks:
        tj = json.loads((scene / "transforms.json").read_text())
        for fr in tj["frames"]:
            fr.pop("mask_file_path", None)
        (scene / "transforms.json").write_text(json.dumps(tj))
    argv = ["--data", str(scene), "--iterations", str(iterations),
            "--scan-chunk", "4", "--warmup-length", "4",
            "--stop-split-at", "600", "--steps-per-save", str(iterations),
            "--capacity", "4096", "--sh-degree", "1",
            "--tile-capacity", "256", "--mesh", "--device-mesh", "data=2"]
    w = World(2, root)
    try:
        res = w.run(CASES.pipeline_run, argv=argv, out_root=str(root / "out"))
    finally:
        w.close()
    _ranks_agree(res)
    assert [r["rank"] for r in res] == [0, 1]
    assert res[0]["history"] == res[1]["history"]
    assert res[0]["history"][-1]["step"] == iterations
    assert np.isfinite(res[0]["history"][-1]["psnr"])
    assert {f"ckpt_{iterations}", "metrics.json"} <= set(res[0]["files"])
    assert res[1]["files"] == []
    return res


def test_fs_train_device_mesh_on_two_ranks(tmp_path_factory):
    """fs-train --device-mesh data=2 (ZeRO-1) in two gloo ranks on a 64x48
    blob capture: both ranks train the same state; rank 0 alone writes the
    checkpoint and metrics.json (each rank is given its own output
    directory here, so rank 1's stays empty)."""
    _fs_train_two_ranks(tmp_path_factory.mktemp("mesh_cli"), 8)


def test_fs_train_device_mesh_without_masks(tmp_path_factory):
    """The same on a capture with no masks, so no hull and no hull pruning:
    the only callback is rank 0's high-grad export. The chunk boundary at
    step 8 is no refine step; rank 0's callback must not make it run
    collectives that rank 1 skips (the ranks would pair different
    collectives and hang)."""
    res = _fs_train_two_ranks(tmp_path_factory.mktemp("mesh_nomask"), 12,
                              masks=False)
    assert "foreground_pcd.ply" not in res[0]["files"]
