"""Checkpoints, splat PLY and PLY/PCD I/O of the port: the torch checkpoint
round trip, a resumed run against the uninterrupted one, the inference
load's binary-opacity snap, a JAX (Orbax) checkpoint continued in the port
through numpy and convert.py, and files written by one package read by
the other."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.gaussians import io as IOJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.train import checkpoint as CKJ
from fusionsense_tpu.utils import ply as PLYJ
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.config import (
    ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
)
from fusionsense_tpu_torch.data.synthetic import (
    ring_cameras, sphere_depth_normals, sphere_points,
)
from fusionsense_tpu_torch.gaussians import io as IOT
from fusionsense_tpu_torch.gaussians.adc import ADCConfig, init_stats
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
from fusionsense_tpu_torch.train import checkpoint as CKT
from fusionsense_tpu_torch.train.optim import init_adam
from fusionsense_tpu_torch.train.trainer import TrainData, Trainer
from fusionsense_tpu_torch.utils import ply as PLYT
from test_torch_train import (  # noqa: F401  (jax_split_noise: a fixture)
    CFJ, CFT, RCJ, RCT, TRJ, _cfg, _with, jax_split_noise,
)


def _state(n=20, capacity=32, seed=0):
    rng = np.random.RandomState(seed)
    pts = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    return init_from_points(pts, torch.full((n, 3), 0.5), capacity=capacity,
                            sh_degree=2)


def test_checkpoint_roundtrip(tmp_path):
    g = _state()
    g.frozen[3] = True
    opt = init_adam(g.params())
    opt.m["means"] = torch.ones_like(opt.m["means"])
    opt.counts["means"] = torch.tensor(5, dtype=torch.int32)
    stats = init_stats(32, "cpu")
    stats.count[1] = 7
    cam = (torch.full((3, 6), 0.25), init_adam({"cam_delta": torch.zeros(3, 6)}))
    p = tmp_path / "ckpt_100"
    CKT.save_checkpoint(p, g, opt, stats, 100, extra={"experiment": "test"},
                        cam_state=cam)
    assert (tmp_path / "ckpt_100.meta.json").exists() and p.is_dir()
    g2, opt2, stats2, step, cam2, meta = CKT.load_checkpoint_full(p, "cpu")
    assert step == 100 and meta == {"experiment": "test"}
    for k, v in g.fields().items():
        assert getattr(g2, k).dtype == v.dtype
        assert torch.equal(getattr(g2, k), v), k
    assert torch.equal(opt2.m["means"], opt.m["means"])
    assert int(opt2.counts["means"]) == 5
    assert int(stats2.count[1]) == 7 and stats2.count.dtype == torch.int32
    assert torch.equal(cam2[0], cam[0])
    g3, _, _, step3 = CKT.load_checkpoint(p, "cpu")
    assert step3 == 100 and torch.equal(g3.means, g.means)
    # plain tensors only: loadable with weights_only=True
    tree = torch.load(p / CKT.STATE_FILE, weights_only=True)
    assert set(tree) == {"gaussians", "opt", "stats", "step", "cam"}


def _mini_trainer(binary=True, adc=None, camera_opt=True):
    """The port's twin of test_checkpoint.py's mini trainer."""
    cams = ring_cameras(n_views=3, width=64, height_px=48, focal=60.0,
                        device="cpu")
    pts, rgb, normals = sphere_points(n=120, radius=0.5, device="cpu")
    g = init_from_points(pts, rgb, capacity=256, sh_degree=1,
                         seed_normals=normals)
    dn = [sphere_depth_normals(cams.index(i)) for i in range(3)]
    data = TrainData(images=torch.zeros((3, 48, 64, 3)) + 0.4,
                     sensor_depths=torch.stack([d[0] for d in dn]),
                     normals=torch.stack([d[1] for d in dn]))
    rcfg = RasterizeConfig(tile_size=16, tile_capacity=128,
                           max_tiles_per_gaussian=4, tile_chunk=10,
                           sh_degree=1, backend="flat")
    cfg = ExperimentConfig(
        model=ModelConfig(sh_degree=1, rasterize=rcfg, capacity=256,
                          binary_opacities=binary),
        train=TrainConfig(iterations=40, scan_chunk=10, log_every=10,
                          camera_opt=camera_opt, camera_opt_every_k=5,
                          adc=adc or ADCConfig()),
        loss=LossConfig(sensor_depth_lambda=0.1))
    return Trainer(cfg, cams, data, g, device="cpu")


def test_trainer_resume_matches_uninterrupted(tmp_path):
    """Saved at step 20 (after refines at 10 and 20), restored into a fresh
    trainer and run to 40 beside the uninterrupted trainer: the same
    losses, population, policies, pose deltas and parameters."""
    adc = ADCConfig(warmup=10, refine_every=10, reset_alpha_every=2,
                    densify_grad_thresh=3e-4)
    tr = _mini_trainer(adc=adc)
    tr.run(iterations=20, log=None)
    tr.tile_capacity = 192          # visibly non-default policy state
    tr.save(tmp_path / "ckpt_mid")
    meta = json.loads((tmp_path / "ckpt_mid.meta.json").read_text())
    assert set(meta) == {"tile_capacity", "cover_tiles", "binary_opacities",
                         "binary_opacity_threshold", "history", "render_n"}

    tr2 = _mini_trainer(adc=adc).restore(tmp_path / "ckpt_mid")
    assert tr2.step == 20 and tr2.tile_capacity == 192
    assert (tr2.render_n, tr2.cover_tiles) == (tr.render_n, tr.cover_tiles)
    assert torch.equal(tr2.cam_state[0], tr.cam_state[0])
    assert float(tr.cam_state[0].abs().max()) > 0
    assert torch.equal(tr2.opt.m["means"], tr.opt.m["means"])
    h1 = tr.run(iterations=40, log=None)[-2:]
    h2 = tr2.run(iterations=40, log=None)
    assert [r["step"] for r in h2] == [r["step"] for r in h1] == [30, 40]
    for a, b in zip(h1, h2):
        for k in ("loss", "psnr", "num_gaussians", "capacity", "pairs_used"):
            assert a[k] == b[k], k
    for k, v in tr.gaussians.fields().items():
        assert torch.equal(getattr(tr2.gaussians, k), v), k
    assert torch.equal(tr2.cam_state[0], tr.cam_state[0])


def test_trainer_resume_rejects_mismatched_views(tmp_path):
    tr = _mini_trainer()
    tr.run(iterations=10, log=None)
    tr.save(tmp_path / "ckpt")
    tr2 = _mini_trainer()
    tr2.num_views = 5     # a different scene
    with pytest.raises(ValueError, match="3 camera deltas"):
        tr2.restore(tmp_path / "ckpt")
    tr3 = _mini_trainer()
    tr3.max_capacity = 128
    with pytest.raises(ValueError, match="capacity 256"):
        tr3.restore(tmp_path / "ckpt")


def test_periodic_checkpoints(tmp_path):
    tr = _mini_trainer()
    tr.cfg = dataclasses.replace(tr.cfg, train=dataclasses.replace(
        tr.cfg.train, steps_per_save=10))
    tr.checkpoint_dir = str(tmp_path)
    tr.run(iterations=20, log=None)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_10", "ckpt_10.meta.json", "ckpt_20", "ckpt_20.meta.json"]
    g, step, cam = CKT.load_for_inference(tmp_path / "ckpt_20", "cpu")
    assert step == 20 and torch.equal(cam[0], tr.cam_state[0])


def test_load_for_inference_rebinarizes(tmp_path):
    tr = _mini_trainer()
    assert tr.cfg.model.binary_opacities
    mid = torch.linspace(-2.0, 2.0, tr.gaussians.capacity)
    tr.gaussians = tr.gaussians.replace(logit_opacities=mid)
    tr.save(tmp_path / "ckpt")
    g, step, _ = CKT.load_for_inference(tmp_path / "ckpt", "cpu")
    thr = tr.cfg.model.binary_opacity_threshold
    assert step == 0
    assert set(torch.unique(g.logit_opacities).tolist()) <= {0.0, 1.0}
    assert torch.equal(g.logit_opacities, (mid >= thr).float())

    tr2 = _mini_trainer(binary=False)
    tr2.gaussians = tr2.gaussians.replace(logit_opacities=mid)
    tr2.save(tmp_path / "ckpt2")
    g2, _, _ = CKT.load_for_inference(tmp_path / "ckpt2", "cpu")
    assert torch.equal(g2.logit_opacities, mid)


def import_jax_checkpoint(trainer, path):
    """A JAX (Orbax) checkpoint restored through numpy and convert.py into a
    port Trainer, as Trainer.restore does with its own format."""
    g, opt, stats, step, cam_state, meta = CKJ.load_checkpoint_full(path)
    adam_np = lambda o: {t: {k: np.asarray(v)  # noqa: E731
                             for k, v in getattr(o, t).items()}
                         for t in ("m", "v", "acc", "counts")}
    trainer.gaussians = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in dict(g).items()}, trainer.device)
    trainer.opt = convert.adam_from_numpy(adam_np(opt), trainer.device)
    trainer.stats = convert.stats_from_numpy(
        {k: np.asarray(v) for k, v in dict(stats).items()}, trainer.device)
    trainer.step = step
    trainer.cam_state = convert.cam_state_from_numpy(
        np.asarray(cam_state[0]), adam_np(cam_state[1]), trainer.device)
    trainer.tile_capacity = int(meta["tile_capacity"])
    trainer.cover_tiles = int(meta["cover_tiles"])
    trainer._recompact(int(trainer.gaussians.num_alive))
    return trainer


def _both_packages_scene():
    """One small scene in both packages from the same numbers: 3 views at
    64x48, 150 sphere points, flat grey images, the sphere's depth and
    normals."""
    from fusionsense_tpu.data import synthetic as SYNJ

    cams_j = SYNJ.ring_cameras(n_views=3, width=64, height_px=48, focal=60.0)
    cams_t = ring_cameras(n_views=3, width=64, height_px=48, focal=60.0,
                          device="cpu")
    pts, rgb, nrm = SYNJ.sphere_points(n=150, radius=0.5)
    g = init_j(pts, rgb, capacity=512, sh_degree=3, seed_normals=nrm)
    dn = [SYNJ.sphere_depth_normals(cams_j.index(i)) for i in range(3)]
    data = {"images": np.full((3, 48, 64, 3), 0.4, np.float32),
            "sensor_depths": np.stack([np.asarray(d[0]) for d in dn]),
            "normals": np.stack([np.asarray(d[1]) for d in dn])}
    g_np = {k: np.asarray(v) for k, v in dict(g).items()}
    return ((cams_j, TRJ.TrainData(**{k: jnp.asarray(v)
                                      for k, v in data.items()}), g),
            (cams_t, convert.train_data_from_numpy(data, "cpu"),
             convert.state_from_numpy(g_np, "cpu")))


def test_jax_checkpoint_continues_in_the_port(jax_split_noise, tmp_path):
    """JAX trains 8 steps (refines at 4 and 8) with camera optimisation and
    saves; the port restores that checkpoint and both run 4 more steps
    (the refine and reset at 12): the same boundary record, losses within
    rtol 2e-3, the pose deltas within 1e-5."""
    (cams_j, data_j, st_j), (cams_t, data_t, st_t) = _both_packages_scene()
    kw = {"camera_opt": True, "camera_opt_every_k": 2}
    tr_j = TRJ.Trainer(_with(_cfg(CFJ, RCJ, "flat"), CFJ, **kw), cams_j,
                       data_j, st_j)
    tr_j.run(iterations=8, log=None)
    tr_j.save(tmp_path / "ckpt_8")
    tr_t = Trainer(_with(_cfg(CFT, RCT, "flat"), CFT, **kw), cams_t, data_t,
                   st_t, device="cpu")
    import_jax_checkpoint(tr_t, tmp_path / "ckpt_8")
    assert tr_t.step == 8
    assert (tr_t.render_n, tr_t.tile_capacity, tr_t.cover_tiles) == (
        tr_j.render_n, tr_j.tile_capacity, tr_j.cover_tiles)
    rj = tr_j.run(iterations=12, log=None)[-1]
    rt = tr_t.run(iterations=12, log=None)[-1]
    assert rt["step"] == rj["step"] == 12
    np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=2e-3)
    for k in ("num_gaussians", "capacity", "tile_overflow"):
        assert rt[k] == rj[k], k
    assert rt["num_gaussians"] != 150          # the refines changed it
    assert (tr_t.render_n, tr_t.tile_capacity, tr_t.cover_tiles) == (
        tr_j.render_n, tr_j.tile_capacity, tr_j.cover_tiles)
    np.testing.assert_allclose(tr_t.cam_state[0].numpy(),
                               np.asarray(tr_j.cam_state[0]), atol=1e-5)
    assert float(tr_t.cam_state[0].abs().max()) > 1e-4


def test_splat_ply_crosses_packages(tmp_path):
    g = _state(n=30, capacity=64, seed=1)
    g.alive[[3, 17]] = False
    g.features_rest.normal_(generator=torch.Generator().manual_seed(0))
    n = IOT.export_splat_ply(tmp_path / "port.ply", g)
    assert n == 28
    gj = IOJ.import_splat_ply(tmp_path / "port.ply")
    alive = g.alive.numpy()
    aj = np.asarray(gj.alive)
    assert int(aj.sum()) == 28 and gj.features_rest.shape[1] == 8
    for k in ("means", "log_scales", "logit_opacities", "features_dc",
              "features_rest"):
        np.testing.assert_allclose(np.asarray(getattr(gj, k))[aj],
                                   getattr(g, k).numpy()[alive], atol=1e-6,
                                   err_msg=k)
    q = g.quats.numpy()[alive]
    np.testing.assert_allclose(np.asarray(gj.quats)[aj],
                               q / np.linalg.norm(q, axis=-1, keepdims=True),
                               atol=1e-6)
    # and back: JAX exports, the port imports
    IOJ.export_splat_ply(tmp_path / "jax.ply", gj)
    gt = IOT.import_splat_ply(tmp_path / "jax.ply", device="cpu")
    for k, v in gt.fields().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(gj, k)),
                                   atol=1e-6, err_msg=k)
    g0 = init_j(jnp.zeros((5, 3)), jnp.full((5, 3), 0.5), capacity=8,
                sh_degree=0)
    IOJ.export_splat_ply(tmp_path / "sh0.ply", g0)
    assert IOT.import_splat_ply(tmp_path / "sh0.ply", capacity=8,
                                device="cpu").features_rest.shape == (8, 0, 3)


def test_ply_and_pcd_io_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(size=(40, 3)).astype(np.float32)
    nrm = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.randint(0, 40, (17, 3))
    extra = {"value": rng.normal(size=40), "pair": rng.normal(size=(40, 2))}
    for writer, reader, name in ((PLYT.write_ply, PLYJ.read_ply, "a.ply"),
                                 (PLYJ.write_ply, PLYT.read_ply, "b.ply")):
        writer(tmp_path / name, pts, colors=cols, normals=nrm, faces=faces,
               extra=extra)
        got, want = reader(tmp_path / name), PLYT.read_ply(tmp_path / name)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    (tmp_path / "c.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
        "property float y\nproperty float z\nproperty uchar red\n"
        "property uchar green\nproperty uchar blue\nend_header\n"
        "0 1 2 255 0 0\n3 4 5 0 128 255\n")
    a, b = PLYT.read_ply(tmp_path / "c.ply"), PLYJ.read_ply(tmp_path / "c.ply")
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    PLYT.write_pcd(tmp_path / "a.pcd", pts, colors=cols, extra=extra)
    PLYJ.write_pcd(tmp_path / "b.pcd", pts, colors=cols, extra=extra)
    assert (tmp_path / "a.pcd").read_text() == (tmp_path / "b.pcd").read_text()
    a, b = PLYT.read_pcd(tmp_path / "a.pcd"), PLYJ.read_pcd(tmp_path / "a.pcd")
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
