"""The port's pipeline stages and fs-train against the JAX package's: the
visual hull and the seed cloud from depth, DBSCAN (against scikit-learn)
and the high-gradient export, the evaluation metrics and `evaluate`, the
debug image grid, the whole pipeline on two copies of one blob scene, and
the training CLI."""
import dataclasses
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fusionsense_tpu.priors.visual_hull as VHJ
import fusionsense_tpu_torch.gaussians.init as INITT
import fusionsense_tpu_torch.pipeline as PIPET
from fusionsense_tpu import config as CFJ
from fusionsense_tpu import pipeline as PIPEJ
from fusionsense_tpu.cli import train as CLIJ
from fusionsense_tpu.core.transforms import random_quats as random_quats_j
from fusionsense_tpu.data import dataparser as DPJ
from fusionsense_tpu.eval import evaluator as EVJ
from fusionsense_tpu.eval import metrics as MJ
from fusionsense_tpu.gaussians import adc as ADCJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.gaussians.init import knn_mean_dist as knn_mean_dist_j
from fusionsense_tpu.priors import pcd_init as PCJ
from fusionsense_tpu.render.rasterize import RasterizeConfig as RCJ
from fusionsense_tpu.touch_select import high_grad as HGJ
from fusionsense_tpu.train import trainer as TRJ
from fusionsense_tpu_torch import config as CFT
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.cli import train as CLIT
from fusionsense_tpu_torch.data import dataparser as DPT
from fusionsense_tpu_torch.data.fixture import write_blob_scene
from fusionsense_tpu_torch.data.image_io import read_image
from fusionsense_tpu_torch.eval import evaluator as EVT
from fusionsense_tpu_torch.eval import metrics as MT
from fusionsense_tpu_torch.gaussians import adc as ADCT
from fusionsense_tpu_torch.priors import pcd_init as PCT
from fusionsense_tpu_torch.priors import visual_hull as VHT
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from fusionsense_tpu_torch.touch_select import high_grad as HGT
from fusionsense_tpu_torch.train import trainer as TRT
from fusionsense_tpu_torch.utils.ply import read_pcd, read_ply, write_pcd

W, H, V = 64, 48, 5
# a coarse hull grid keeps the (capacity, hull) prune small on the CPU
HULL = dict(voxel_size=0.02)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops on a shared CPU run far faster on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """A 64x48 blob capture with a touch patch, written by the port's
    fixture writer (tests/test_torch_data.py holds it to JAX's), and both
    packages' parse of its train split."""
    scene = tmp_path_factory.mktemp("blob") / "scene"
    write_blob_scene(scene, n_views=V, width=W, height=H, focal=55.0,
                     n_gt=800, n_seed_pts=300, device="cpu")
    cfg_j = DPJ.DataParserConfig(data_dir=str(scene))
    cfg_t = DPT.DataParserConfig(data_dir=str(scene))
    sj, st = DPJ.parse_transforms(cfg_j), DPT.parse_transforms(cfg_t, "cpu")
    return (scene, (sj, *DPJ.load_train_data(sj, cfg_j)),
            (st, *DPT.load_train_data(st, cfg_t)))


# --------------------------------------------------------------- priors ----

def test_visual_hull_and_seed_cloud_match_jax(blob, monkeypatch):
    """The hull's symmetric difference within 0.1% of the hull (a voxel
    whose projection lands on a pixel edge may vote differently in XLA and
    torch float32); the port's vote in several chunks. The seed cloud from
    depth, with and without the hull, within 1e-6 and the same count."""
    _, (_, cj, dj), (_, ct, dt) = blob
    hj = VHJ.visual_hull(dj.masks, cj, cfg=VHJ.VisualHullConfig(
        voxel_size=0.01))
    monkeypatch.setattr(VHT, "_CHUNK", 1 << 16)
    ht = VHT.visual_hull(dt.masks, ct, cfg=VHT.VisualHullConfig(
        voxel_size=0.01))
    assert len(hj) > 1000
    key = lambda p: set(map(tuple, np.round(p / 0.01 - 0.5).astype(int)))  # noqa: E731
    kj, kt = key(hj), key(ht)
    assert len(kj ^ kt) <= 1e-3 * len(kj), len(kj ^ kt)
    common = sorted(kj & kt)
    pick = lambda p: p[np.lexsort(np.round(p / 0.01 - 0.5).astype(int).T[::-1])]  # noqa: E731
    if len(kj) == len(kt) == len(common):
        np.testing.assert_allclose(pick(ht), pick(hj), atol=1e-6, rtol=0)

    for hull in (None, hj):
        pj, cj_ = PCJ.seed_pcd_from_depths(dj.sensor_depths, dj.images, cj,
                                           hull_points=hull)
        pt, ct_ = PCT.seed_pcd_from_depths(dt.sensor_depths, dt.images, ct,
                                           hull_points=hull)
        assert pt.shape == pj.shape and pt.dtype == np.float32
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ct_, cj_, atol=1e-7, rtol=0)


def test_voxel_downsample_keeps_first_hit():
    rng = np.random.RandomState(3)
    pts = rng.rand(2000, 3).astype(np.float32)
    cols = rng.rand(2000, 3).astype(np.float32)
    pj, cj = PCJ.voxel_downsample(pts, cols, 0.1)
    pt, ct = PCT.voxel_downsample(torch.tensor(pts), torch.tensor(cols), 0.1)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(ct.numpy(), cj)


# ----------------------------------------------------- high-grad export ----

def _clusters(seed, n_noise=60):
    rng = np.random.RandomState(seed)
    centers = rng.rand(4, 3) * 0.3
    blobs = [c + rng.randn(rng.randint(20, 80), 3) * rng.uniform(0.002, 0.006)
             for c in centers]
    noise = rng.rand(n_noise, 3) * 0.3
    pts = np.concatenate(blobs + [noise]).astype(np.float32)
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("seed", range(6))
def test_dbscan_labels_equal_sklearn(seed):
    DBSCAN = pytest.importorskip("sklearn.cluster").DBSCAN
    pts = _clusters(seed)
    for eps, ms in ((0.01, 15), (0.015, 5), (0.03, 10)):
        want = DBSCAN(eps=eps, min_samples=ms).fit_predict(pts)
        got = HGT.dbscan(pts, eps, ms)
        np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() and (want < 0).any()
    assert len(HGT.dbscan(pts[:0], 0.01, 15)) == 0


def test_export_high_grad_pcd_matches_jax(tmp_path):
    """The same state and stats through both exports: the same .pcd bytes
    (selection, hull distance, clusters, ranks, capture coordinates)."""
    pytest.importorskip("sklearn")
    rng = np.random.RandomState(0)
    C = 1024
    pts = np.concatenate([_clusters(1, 40), rng.rand(C, 3) * 0.3])[:C]
    init = init_j(jnp.asarray(pts, jnp.float32), jnp.full((C, 3), 0.5),
                  capacity=C, sh_degree=1,
                  seed_normals=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (C, 1)))
    st = {k: np.array(v) for k, v in dataclasses.asdict(init).items()}
    st["alive"][::17] = False
    count = rng.randint(0, 4, C).astype(np.int32)
    grad = (rng.rand(C) * 1e-3).astype(np.float32)
    grad[: C // 4] *= 20          # the clusters are the uncertain regions
    stats = {"grad2d_acc": grad, "count": count,
             "max_radius": np.zeros(C, np.float32)}
    hull = pts[:300] + 0.002
    untransform = lambda p: p / 0.5 + np.array([0.1, -0.2, 0.3])  # noqa: E731
    from fusionsense_tpu.gaussians.store import GaussianState

    nj = HGJ.export_high_grad_pcd(
        tmp_path / "j.pcd",
        GaussianState(**{k: jnp.asarray(v) for k, v in st.items()}),
        ADCJ.RefineStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
        hull, untransform=untransform)
    nt = HGT.export_high_grad_pcd(
        tmp_path / "t.pcd", convert.state_from_numpy(st, "cpu"),
        convert.stats_from_numpy(stats, "cpu"), hull, untransform=untransform)
    assert nt == nj > 15
    assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
    assert len(np.unique(read_pcd(tmp_path / "t.pcd")["grad_rank"])) >= 1
    # an export that keeps no point still reads back
    write_pcd(tmp_path / "e.pcd", np.zeros((0, 3)),
              extra={"grad": np.zeros(0), "cluster": np.zeros(0)})
    assert read_pcd(tmp_path / "e.pcd")["points"].shape == (0, 3)


# -------------------------------------------------------------- metrics ----

def test_metrics_match_jax():
    rng = np.random.RandomState(4)
    a = rng.rand(H, W, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(H, W, 3), 0, 1).astype(np.float32)
    d1 = rng.uniform(0.05, 2.0, (H, W)).astype(np.float32)
    d2 = (d1 * (1 + 0.1 * rng.randn(H, W))).astype(np.float32)
    m = (rng.rand(H, W) > 0.4).astype(np.float32)
    n1, n2 = rng.randn(2, H, W, 3).astype(np.float32)
    J, T = jnp.asarray, torch.tensor
    pairs = [
        (MJ.psnr(J(a), J(b)), MT.psnr(T(a), T(b))),
        (MJ.masked_psnr(J(a), J(b), J(m)), MT.masked_psnr(T(a), T(b), T(m))),
        (MJ.ssim(J(a), J(b)), MT.ssim(T(a), T(b))),
        (MJ.angular_error_deg(J(n1), J(n2)), MT.angular_error_deg(T(n1), T(n2))),
    ]
    dicts = [
        (MJ.rgb_metrics(J(a), J(b), J(m)), MT.rgb_metrics(T(a), T(b), T(m))),
        (MJ.depth_metrics(J(d1), J(d2)), MT.depth_metrics(T(d1), T(d2))),
        (MJ.depth_metrics(J(d1), J(d2), mask=J(m)),
         MT.depth_metrics(T(d1), T(d2), mask=T(m))),
        (MJ.normal_metrics(J(n1), J(n2)), MT.normal_metrics(T(n1), T(n2))),
        (MJ.normal_metrics(J(n1), J(n2), J(m)),
         MT.normal_metrics(T(n1), T(n2), T(m))),
        (MJ.normal_metrics(J(n1), J(n2), J(d2) > 1.0),
         MT.normal_metrics(T(n1), T(n2), T(d2) > 1.0)),
    ]
    for dj, dt in dicts:
        assert set(dj) == set(dt)
        pairs += [(dj[k], dt[k]) for k in dj]
    for j, t in pairs:
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=1e-5)
    p, q = rng.rand(300, 3), rng.rand(200, 3)
    assert MT.pd_metrics(p, q) == MJ.pd_metrics(p, q)
    assert MT.chamfer_distance(p, q) == MJ.chamfer_distance(p, q)


def test_lpips_gate(tmp_path, monkeypatch):
    """Without a weights file the backends are JAX's (the lpips package,
    then torchmetrics); a weights file for the in-repo net raises, naming
    its ROADMAP item, instead of being passed over."""
    from fusionsense_tpu.eval import lpips as LPJ
    from fusionsense_tpu_torch.eval import lpips as LPT

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("FUSIONSENSE_LPIPS_WEIGHTS", raising=False)
    for mod in (LPJ, LPT):
        monkeypatch.setattr(mod, "_kind", None)
    assert LPT.available() == LPJ.available()
    (tmp_path / "w.npz").write_bytes(b"")
    monkeypatch.setenv("FUSIONSENSE_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    monkeypatch.setattr(LPT, "_kind", None)
    with pytest.raises(NotImplementedError, match="A14"):
        LPT.available()


# ----------------------------------------------------- evaluate, grids -----

def _state(sj):
    """A JAX init from the scene's seed cloud, as numpy."""
    init = init_j(jnp.asarray(sj.seed_points), jnp.asarray(sj.seed_colors),
                  capacity=1024, sh_degree=1)
    return {k: np.asarray(v) for k, v in dataclasses.asdict(init).items()}


@pytest.mark.parametrize("backend", ["jax", "flat"])
def test_evaluate_matches_jax(blob, backend):
    """Per-view metrics within 1e-4 (fps excluded) on one state; the flat
    backend starts at a pair budget the scene overflows, so its renders go
    through the budget retry."""
    _, (sj, cj, dj), (_, ct, dt) = blob
    st = _state(sj)
    from fusionsense_tpu.gaussians.store import GaussianState

    kw = dict(tile_size=16, tile_capacity=64 if backend == "flat" else 256,
              max_tiles_per_gaussian=16, sh_degree=1, backend=backend)
    rj = EVJ.evaluate(GaussianState(**{k: jnp.asarray(v) for k, v in st.items()}),
                      cj, dj, RCJ(**kw))
    rt = EVT.evaluate(convert.state_from_numpy(st, "cpu"), ct, dt, RCT(**kw))
    assert len(rt["per_view"]) == len(rj["per_view"]) == V - 1
    for pj, pt in zip(rj["per_view"], rt["per_view"]):
        assert set(pj) == set(pt)
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    assert rt["mean"]["num_gaussians"] == rj["mean"]["num_gaussians"]
    assert rt["mean"]["fps"] > 0 and rt["mean"]["mpix_per_s"] > 0


def test_debug_grid_matches_jax(blob, tmp_path):
    """The GT | rgb | depth | normal strip of a step's view, as JAX's PNG,
    within one level."""
    _, (sj, cj, dj), (_, ct, dt) = blob
    st = _state(sj)
    from fusionsense_tpu.gaussians.store import GaussianState

    def cfg(mod, rc):
        return mod.ExperimentConfig(model=mod.ModelConfig(
            sh_degree=1, capacity=1024, binary_opacities=False,
            rasterize=rc(tile_size=16, tile_capacity=256,
                         max_tiles_per_gaussian=16, sh_degree=1)))
    tj = TRJ.Trainer(cfg(CFJ, RCJ), cj, dj, GaussianState(
        **{k: jnp.asarray(v) for k, v in st.items()}))
    tt = TRT.Trainer(cfg(CFT, RCT), ct, dt, convert.state_from_numpy(st, "cpu"),
                     device="cpu")
    for tr, d in ((tj, "j"), (tt, "t")):
        tr.step, tr.image_log_dir = 6, str(tmp_path / d)
        tr._dump_debug_grid()
    a, b = (read_image(tmp_path / d / "step_000006.png").astype(int)
            for d in ("j", "t"))
    assert a.shape == (H, 4 * W, 3)
    assert np.abs(a - b).max() <= 1


# ---------------------------------------------------- the whole pipeline ---

# 20 steps: refines at 8 and 16 (the refine at 24 would add a few hundred
# Gaussians on densify decisions whose gradients sit within float32 noise
# of the threshold)
SLICE_STEPS = 20


def _pipeline_cfg(mod, dp, rc, adc_mod, scene, out, **kw):
    return mod.PipelineConfig(
        data=dp.DataParserConfig(data_dir=str(scene), load_touches=True),
        experiment=mod.ExperimentConfig(
            model=mod.ModelConfig(
                sh_degree=1, capacity=2048, binary_opacities=False,
                sh_degree_interval=8,
                rasterize=rc(tile_size=16, tile_capacity=1024,
                             max_tiles_per_gaussian=16, tile_chunk=24,
                             sh_degree=1, backend="jax")),
            train=mod.TrainConfig(
                # one step per JAX scan: its 4-step scan rounds differently
                # from single steps, by up to 3e-3 of the loss by step 20
                iterations=SLICE_STEPS, scan_chunk=1, log_every=4,
                add_touch_at=12, steps_per_save=12,
                adc=adc_mod.ADCConfig(warmup=8, refine_every=8,
                                      stop_split_at=504,
                                      densify_grad_thresh=2e-4,
                                      reset_alpha_every=10_000)),
            loss=mod.LossConfig(normal_lambda=0.2, sensor_depth_lambda=0.2,
                                smooth_lambda=0.01, flatness_lambda=0.0,
                                mono_depth_lambda=0.0)),
        output_dir=str(out), **kw)


class _JaxPipelineConfig:
    """The JAX package's pipeline config names, gathered like the port's
    module."""
    PipelineConfig = PIPEJ.PipelineConfig
    ExperimentConfig = CFJ.ExperimentConfig
    ModelConfig = CFJ.ModelConfig
    TrainConfig = CFJ.TrainConfig
    LossConfig = CFJ.LossConfig


class _PortPipelineConfig:
    PipelineConfig = PIPET.PipelineConfig
    ExperimentConfig = CFT.ExperimentConfig
    ModelConfig = CFT.ModelConfig
    TrainConfig = CFT.TrainConfig
    LossConfig = CFT.LossConfig


@pytest.fixture
def jax_draws(monkeypatch):
    """The port draws what the JAX pipeline draws: the refine's split
    normals for the JAX trainer's per-step key, and the init's quaternions
    for PRNGKey(0); both packages carve the hull on the coarse grid."""
    def noise(generator, n, capacity, device=None):
        key = jax.random.PRNGKey(np.uint32(generator.initial_seed()))
        keys = jax.random.split(key, max(n, 2))
        return torch.tensor(np.stack([np.asarray(jax.random.normal(
            k, (capacity, 3))) for k in keys]), device=device)

    def quats(n, generator=None, device=None):
        return torch.tensor(np.asarray(random_quats_j(jax.random.PRNGKey(0), n)),
                            device=device)
    def knn(points, k=3, chunk=4096):
        return torch.tensor(np.asarray(knn_mean_dist_j(
            jnp.asarray(points.cpu().numpy()), k, chunk)), device=points.device)
    monkeypatch.setattr(TRT, "split_noise", noise)
    monkeypatch.setattr(INITT, "random_quats", quats)
    monkeypatch.setattr(INITT, "knn_mean_dist", knn)
    monkeypatch.setattr(VHJ, "visual_hull", functools.partial(
        VHJ.visual_hull, cfg=VHJ.VisualHullConfig(**HULL)))
    monkeypatch.setattr(PIPET, "visual_hull", functools.partial(
        VHT.visual_hull, cfg=VHT.VisualHullConfig(**HULL)))


def _no_seed_ply(scene):
    """Drop ply_file_path, so the hull and the seed cloud from depth run."""
    meta = json.loads((scene / "transforms.json").read_text())
    meta.pop("ply_file_path")
    (scene / "transforms.json").write_text(json.dumps(meta))


def test_pipeline_matches_jax(blob, tmp_path, jax_draws, monkeypatch):
    """Both pipelines on two copies of the blob scene with no seed cloud.
    The priors first: each carves its hull and backprojects its seed cloud;
    the PLYs agree within float32 backprojection error and both land in
    the scene's transforms.json. Then both train from the same registered
    priors (JAX's PLYs: a 1e-7 move of a seed point can flip a pixel's
    alpha cut-off or a densify decision, which rtol 1e-3 on the losses and
    equal counts do not forgive), backend "jax", 20 steps: refines at 8
    and 16, the touch patch anchored at the step-12 boundary, the high-grad
    export at step 4, hull pruning from step 8. The logged losses (rtol
    1e-3), and the population and frozen counts at every boundary agree;
    then the port resumes from its step-12 checkpoint with the patch
    frozen."""
    scene = blob[0]
    for d in ("j", "t"):
        shutil.copytree(scene, tmp_path / d / "scene")
        _no_seed_ply(tmp_path / d / "scene")

    def pipelines(out, **kw):
        return (PIPEJ.ReconstructionPipeline(_pipeline_cfg(
                    _JaxPipelineConfig, DPJ, RCJ, ADCJ, tmp_path / "j/scene",
                    tmp_path / "j" / out, **kw)),
                PIPET.ReconstructionPipeline(_pipeline_cfg(
                    _PortPipelineConfig, DPT, RCT, ADCT, tmp_path / "t/scene",
                    tmp_path / "t" / out, **kw), device="cpu"))

    for p in pipelines("priors"):
        p.build_priors()
    for f in ("foreground_pcd.ply", "merged_pcd.ply"):
        a, b = (read_ply(tmp_path / d / "priors" / f) for d in ("t", "j"))
        assert a["points"].shape == b["points"].shape, f
        np.testing.assert_allclose(a["points"], b["points"], atol=1e-5,
                                   rtol=0, err_msg=f)
    metas = {}
    for d in ("j", "t"):
        metas[d] = json.loads((tmp_path / d / "scene/transforms.json").read_text())
        assert metas[d]["ply_file_path"] == str(
            tmp_path / d / "priors/merged_pcd.ply")
        assert metas[d]["object_pc_path"] == str(
            tmp_path / d / "priors/foreground_pcd.ply")
    (tmp_path / "t/scene/transforms.json").write_text(json.dumps(metas["j"]))

    pj, pt = pipelines("out")
    counts = {"j": [], "t": []}

    def counting(mod, key):
        """The package's Trainer with one more callback, last: it records
        (step, alive, frozen-alive) at every boundary."""
        def cb(tr):
            frozen = np.asarray(tr.gaussians.frozen) & np.asarray(
                tr.gaussians.alive)
            counts[key].append((tr.step, int(tr.gaussians.num_alive),
                                int(frozen.sum())))

        class Counting(mod.Trainer):
            def __init__(self, *a, extra_callbacks=None, **kw):
                super().__init__(*a, extra_callbacks=[*extra_callbacks, cb],
                                 **kw)
        return Counting
    monkeypatch.setattr(PIPEJ, "Trainer", counting(PIPEJ, "j"))
    monkeypatch.setattr(PIPET, "Trainer", counting(PIPET, "t"))
    logs = {"j": [], "t": []}
    hj = pj.train(log=logs["j"].append)
    ht = pt.train(log=logs["t"].append)

    assert [r["step"] for r in ht] == [r["step"] for r in hj]
    np.testing.assert_allclose([r["loss"] for r in ht],
                               [r["loss"] for r in hj], rtol=1e-3)
    assert counts["t"] == counts["j"]
    frozen = counts["t"][-1][2]
    # the patch is anchored at 12 and stays frozen; nothing is before
    assert frozen > 0 and {c[2] for c in counts["t"] if c[0] >= 12} == {frozen}
    assert {c[2] for c in counts["t"] if c[0] < 12} == {0}
    for d in ("j", "t"):
        out = tmp_path / d / "out"
        assert (out / "high_grad_pts.pcd").exists()
        assert sorted(p.name for p in (out / "log_images").iterdir()) == [
            f"step_{s:06d}.png" for s in range(4, SLICE_STEPS + 1, 4)]
        assert (out / "ckpt_12").exists() and (out / f"ckpt_{SLICE_STEPS}").exists()
    assert "high-grad export" in " ".join(logs["t"])
    res = pt.evaluate()
    assert np.isfinite(res["mean"]["psnr"])
    assert (tmp_path / "t/out/metrics.json").exists()

    # the port resumes from its own step-12 checkpoint
    resumed = {}
    pr = PIPET.ReconstructionPipeline(_pipeline_cfg(
        _PortPipelineConfig, DPT, RCT, ADCT, tmp_path / "t/scene",
        tmp_path / "t/resume", resume=str(tmp_path / "t/out/ckpt_12")),
        device="cpu")
    real_run = TRT.Trainer.run

    def run(tr, *a, **kw):
        resumed["step"] = tr.step
        resumed["frozen"] = int((tr.gaussians.frozen & tr.gaussians.alive).sum())
        return real_run(tr, *a, **kw)
    monkeypatch.setattr(TRT.Trainer, "run", run)
    hr = pr.train(log=None)
    assert resumed == {"step": 12, "frozen": frozen}
    assert hr[-1]["step"] == SLICE_STEPS
    assert int((pr.trainer.gaussians.frozen & pr.trainer.gaussians.alive).sum()
               ) == frozen


# ------------------------------------------------------------------ CLI ----

def _actions(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.required, a.const)
            for a in parser._actions}


def test_cli_parser_matches_jax():
    assert _actions(CLIT.build_parser()) == _actions(CLIJ.build_parser())
    args = CLIT.build_parser().parse_args(["--data", "x"])
    assert args.mesh == ["tsdf", "sugar-coarse"] and args.backend == "jax"


@pytest.mark.parametrize("flags,item", [
    ([], "A14"), (["--mesh", "tsdf"], "A14"),
    (["--mesh", "--device-mesh", "data=2"], "A18"),
    (["--mesh", "--viewer"], "A19")])
def test_cli_refuses_unported_options_before_training(tmp_path, flags, item):
    """Named by their ROADMAP item, before the scene is even read."""
    with pytest.raises(NotImplementedError, match=item):
        CLIT.main(["--data", str(tmp_path / "missing"), *flags], device="cpu")


def test_cli_trains_and_evaluates(blob, tmp_path, monkeypatch, capsys):
    """12 steps of fs-train in the port with an empty --mesh: metrics.json,
    the checkpoint and the priors land in <output>/<experiment>."""
    monkeypatch.setattr(PIPET, "visual_hull", functools.partial(
        VHT.visual_hull, cfg=VHT.VisualHullConfig(**HULL)))
    shutil.copytree(blob[0], tmp_path / "scene")
    pipe = CLIT.main([
        "--data", str(tmp_path / "scene"), "--output-dir", str(tmp_path / "o"),
        "--load-touches", "--iterations", "12", "--scan-chunk", "4",
        "--warmup-length", "4", "--stop-split-at", "504", "--add-touch-at",
        "4", "--capacity", "4096", "--sh-degree", "1", "--tile-capacity",
        "256", "--mesh"], device="cpu")
    out = tmp_path / "o" / "dn_splatter"
    res = json.loads((out / "metrics.json").read_text())
    assert res["mean"]["num_gaussians"] == int(pipe.trainer.gaussians.num_alive)
    assert np.isfinite(res["mean"]["psnr"])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex("\n{"):]) == res["mean"]
    for f in ("ckpt_12", "foreground_pcd.ply", "high_grad_pts.pcd"):
        assert (out / f).exists(), f
    assert int(pipe.trainer.gaussians.frozen.sum()) > 0
