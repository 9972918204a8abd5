"""Fused refine intervals in the port (Trainer.run_fused, sync_policies,
StepInputs) against the JAX package's on the CPU, and bench_torch.py's smoke
run. On the CPU the port runs the same interval code as on the card, the
step eagerly instead of as a CUDA graph replay.

The scene is tests/test_train_e2e.py's fixture_scene (4 views at 64x48,
tile 16, SH degree 1): images rendered by the JAX rasterizer, handed to
both packages as numpy. The split normals of every refine are JAX's draw
for the port's generator seed (as tests/test_torch_train.py's
jax_split_noise does). Tolerances are test_train_e2e.py's
test_run_fused_matches_run: n_alive and the alive mask exact, PSNR within
0.05, means within rtol 1e-4, atol 1e-5, which across the two packages holds
for 99.5% of the coordinates and all within 1e-3: after 150 steps a few
Gaussians differ more (4 of 456 here), nearly transparent ones and children
of the last refine, whose near-zero gradients Adam's normalisation turns
into full-size steps from float32 differences of reduction order. The
port's fused run against its own Trainer.run is exact."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fusionsense_tpu.config as CFJ
import fusionsense_tpu_torch.config as CFT
from fusionsense_tpu.data import synthetic as SYNJ
from fusionsense_tpu.gaussians.adc import ADCConfig as ADCJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.gaussians.store import GaussianState as GSJ
from fusionsense_tpu.gaussians.store import activated as activated_j
from fusionsense_tpu.render.rasterize import RasterizeConfig as RCJ
from fusionsense_tpu.render.rasterize import rasterize as rasterize_j
from fusionsense_tpu.train import optim as OJ
from fusionsense_tpu.train import trainer as TRJ
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.data import synthetic as SYNT
from fusionsense_tpu_torch.gaussians.adc import ADCConfig as ADCT
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig as RCT
from fusionsense_tpu_torch.train import trainer as TRT

ROOT = Path(__file__).resolve().parent.parent
V, W, H = 4, 64, 48
RKW = dict(tile_size=16, tile_capacity=128, max_tiles_per_gaussian=8,
           tile_chunk=12, sh_degree=1)
# the bin-cache case of test_train_e2e.py:367
FLAT_KW = dict(backend="flat", tile_capacity=64, pallas_chunk=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    cams = SYNJ.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0)
    pts, rgb, normals = SYNJ.sphere_points(n=400, radius=0.5)
    gt = init_j(pts, rgb, capacity=512, sh_degree=1, seed_normals=normals,
                init_opacity=0.95)
    m, q, s, o, c = activated_j(gt)
    rc = RCJ(**RKW)
    render = jax.jit(lambda i: rasterize_j(m, q, s, o, c, cams.index(i), rc).rgb)
    dn = [SYNJ.sphere_depth_normals(cams.index(i)) for i in range(V)]
    data = {"images": np.stack([np.asarray(render(i)) for i in range(V)]),
            "sensor_depths": np.stack([np.asarray(d[0]) for d in dn]),
            "normals": np.stack([np.asarray(d[1]) for d in dn])}
    pts2, rgb2, _ = SYNJ.sphere_points(n=150, radius=0.5)
    init = init_j(pts2, rgb2, capacity=1024, sh_degree=1)
    return cams, data, {f.name: np.asarray(getattr(init, f.name))
                        for f in dataclasses.fields(init)}


def _cfg(mod, rc_cls, adc_cls, rkw=None, steps=150, **train_kw):
    """test_train_e2e.py's run_fused configuration in package `mod`."""
    return mod.ExperimentConfig(
        model=mod.ModelConfig(sh_degree=1, rasterize=rc_cls(**(rkw or RKW)),
                              capacity=1024, binary_opacities=False),
        train=mod.TrainConfig(
            iterations=steps, scan_chunk=50, log_every=50,
            auto_capacity=False, auto_tile_capacity=False,
            auto_cover_window=False,
            adc=adc_cls(warmup=50, refine_every=50, stop_split_at=steps,
                        densify_grad_thresh=1e-5, cull_alpha_thresh=0.05),
            **train_kw),
        loss=mod.LossConfig(normal_lambda=0.1, sensor_depth_lambda=0.2,
                            smooth_lambda=0.0, flatness_lambda=0.01))


def _jax_trainer(scene, cfg):
    cams, data, init = scene
    return TRJ.Trainer(cfg, cams,
                       TRJ.TrainData(**{k: jnp.asarray(v) for k, v in data.items()}),
                       GSJ(**{k: jnp.asarray(v) for k, v in init.items()}))


def _torch_trainer(scene, cfg):
    _, data, init = scene
    cams = SYNT.ring_cameras(n_views=V, width=W, height_px=H, focal=60.0,
                             device="cpu")
    return TRT.Trainer(cfg, cams, convert.train_data_from_numpy(data, "cpu"),
                       convert.state_from_numpy(init, "cpu"), device="cpu")


def _jax_noise(generator, n, capacity, device=None):
    """JAX's split normals for the port's refine: the generator's seed is
    the JAX trainer's per-step seed, so the same PRNG key is rebuilt."""
    key = jax.random.PRNGKey(np.uint32(generator.initial_seed()))
    keys = jax.random.split(key, max(n, 2))
    return torch.tensor(np.stack([np.asarray(jax.random.normal(
        k, (capacity, 3))) for k in keys]), device=device)


def _fused_pair(scene, n_intervals, rkw=None, **train_kw):
    """run_fused(n_intervals, 50) and sync_policies in both packages."""
    rkw = rkw or RKW
    steps = 50 * n_intervals
    tr_j = _jax_trainer(scene, _cfg(CFJ, RCJ, ADCJ, rkw, steps, **train_kw))
    ms_j = tr_j.run_fused(n_intervals, interval=50)
    n_j = tr_j.sync_policies(ms_j)
    tr_t = _torch_trainer(scene, _cfg(CFT, RCT, ADCT, rkw, steps, **train_kw))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TRT, "split_noise", _jax_noise)
        ms_t = tr_t.run_fused(n_intervals, interval=50)
    n_t = tr_t.sync_policies(ms_t)
    return tr_j, ms_j, n_j, tr_t, ms_t, n_t


@pytest.fixture(scope="module")
def fused(scene):
    return _fused_pair(scene, 3)


def _same_state(tr_j, n_j, tr_t, n_t, steps):
    assert tr_t.step == tr_j.step == steps
    assert n_t == n_j
    np.testing.assert_array_equal(tr_t.gaussians.alive.numpy(),
                                  np.asarray(tr_j.gaussians.alive))
    a, b = tr_t.gaussians.means.numpy(), np.asarray(tr_j.gaussians.means)
    close = np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    assert abs(tr_t.history[-1]["psnr"] - tr_j.history[-1]["psnr"]) < 0.05


def test_run_fused_matches_jax(fused):
    """Three intervals of 50 with refines at 50 and 100, then the policy
    sync: the state and the history record JAX's sync_policies appends."""
    tr_j, _, n_j, tr_t, _, n_t = fused
    _same_state(tr_j, n_j, tr_t, n_t, 150)
    assert n_t > 150          # the refines densified
    rj, rt = tr_j.history[-1], tr_t.history[-1]
    assert set(rt) == set(rj)
    for k in ("step", "num_gaussians", "tile_overflow", "nonfinite_steps",
              "capacity"):
        assert rt[k] == rj[k], (k, rt[k], rj[k])
    np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-3)
    assert (tr_t.render_n, tr_t.tile_capacity, tr_t.cover_tiles) == (
        tr_j.render_n, tr_j.tile_capacity, tr_j.cover_tiles)


def test_fused_metrics_rows_match_jax(fused):
    """One row per interval: the last step's loss, psnr and telemetry, the
    summed nonfinite count."""
    _, ms_j, _, _, ms_t, _ = fused
    assert set(ms_t) == set(ms_j)
    for k, v in ms_j.items():
        v = np.asarray(v)
        assert ms_t[k].shape == v.shape, k
        if k in ("loss", "psnr"):
            np.testing.assert_allclose(ms_t[k].numpy(), v, rtol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(ms_t[k].numpy(), v, err_msg=k)


def test_fused_bin_cache_matches_jax(scene):
    """The flat backend with views rebinned every 9 steps
    (test_train_e2e.py:367): two intervals, each starting with a stale
    cache, a refine at 50."""
    tr_j, _, n_j, tr_t, _, n_t = _fused_pair(scene, 2, dict(RKW, **FLAT_KW),
                                             bin_refresh_steps=9)
    _same_state(tr_j, n_j, tr_t, n_t, 100)


def _short_cfg(backend):
    """A short schedule for the port against itself: refines at 10 and 20."""
    rkw = dict(RKW, **(FLAT_KW if backend == "flat" else {"backend": backend}))
    cfg = _cfg(CFT, RCT, ADCT, rkw, 30, bin_refresh_steps=9)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, scan_chunk=10, log_every=10, adc=dataclasses.replace(
            cfg.train.adc, warmup=10, refine_every=10)))


@pytest.mark.parametrize("backend", ["jax", "pallas", "flat"])
def test_run_fused_matches_run(scene, backend):
    """The port's fused intervals against its own Trainer.run, refines
    included: on the CPU both run the same arithmetic, so the states are
    equal bit for bit."""
    cfg = _short_cfg(backend)
    tr_a = _torch_trainer(scene, cfg)
    tr_a.run(iterations=30, log=None)
    tr_b = _torch_trainer(scene, cfg)
    n = tr_b.sync_policies(tr_b.run_fused(3, interval=10))
    assert tr_b.step == 30 and n == int(tr_a.gaussians.num_alive)
    for k, v in tr_a.gaussians.fields().items():
        assert torch.equal(v, getattr(tr_b.gaussians, k)), k
    for tree in ("m", "v", "acc", "counts"):
        for k, v in getattr(tr_a.opt, tree).items():
            assert torch.equal(v, getattr(tr_b.opt, tree)[k]), (tree, k)
    assert tr_a.history[-1]["psnr"] == tr_b.history[-1]["psnr"]


def test_run_fused_off_boundary_raises(scene):
    tr = _torch_trainer(scene, _short_cfg("jax"))
    tr.run(iterations=3, log=None)
    with pytest.raises(ValueError, match="not on a refine boundary"):
        tr.run_fused(1, interval=10)
    assert tr.step == 3


# ------------------------------------------------- the device-input step --

# a schedule on which every step-dependent value changes within a few steps:
# the SH band every 4 steps, the binary-opacity surgery on at steps 6-9 of
# each 8 (warmup 2, skip 2 * 4, margin 3), the feature groups' every_k=10
# gate at steps 9 and 19, the pose deltas' every_k=2 gate at odd steps, and
# the means' decaying learning rate at every step
STEP_ADC = dict(warmup=2, refine_every=4, reset_alpha_every=2,
                stop_split_at=100)


def _step_cfg(mod, rc_cls, adc_cls):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(sh_degree=1, rasterize=rc_cls(**RKW),
                              capacity=1024, binary_opacities=True,
                              binary_opacity_margin=3, sh_degree_interval=4),
        train=mod.TrainConfig(camera_opt=True, camera_opt_every_k=2,
                              adc=adc_cls(**STEP_ADC)),
        loss=mod.LossConfig())


@pytest.mark.parametrize("step", [4, 5, 6, 8, 9, 10])
def test_device_input_step_matches_eager_and_jax(scene, step):
    """One step at `step` from the same state: the step reading StepInputs
    from a StepSchedule row equals the eager step bit for bit, and both
    match JAX's step within the state tolerance."""
    cams_j, data, init = scene
    tr_t = _torch_trainer(scene, _step_cfg(CFT, RCT, ADCT))
    cfg_t, v = tr_t.cfg, step % V
    sched = TRT.StepSchedule(cfg_t)
    kw = dict(cfg=cfg_t, camera=tr_t.camera, data=tr_t.data)
    state = (tr_t.gaussians, tr_t.opt, tr_t.cam_state, tr_t.stats)
    eager = TRT.train_step(*state, step, v, **kw)
    dev = TRT.train_step(*state, None, v,
                         inputs=sched.inputs(sched.rows([step])[0]), **kw)
    for a, b in zip(TRT._state_tensors(*eager[:4]),
                    TRT._state_tensors(*dev[:4])):
        assert torch.equal(a, b)

    cfg_j = _step_cfg(CFJ, RCJ, ADCJ)
    tr_j = _jax_trainer(scene, cfg_j)
    chunk = TRJ.make_train_chunk(cfg_j, cams_j, tr_j.data)
    g, o, (deltas, _), st, _ = chunk(tr_j.gaussians, tr_j.opt, tr_j.cam_state,
                                     tr_j.stats, jnp.int32(step),
                                     jnp.asarray([v], jnp.int32))
    g_t, o_t, (deltas_t, _), _, m_t = dev
    for k in g_t.params():
        np.testing.assert_allclose(getattr(g_t, k).numpy(),
                                   np.asarray(getattr(g, k)),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k, c in o_t.counts.items():
        assert int(c) == int(o.counts[k]), k
    np.testing.assert_allclose(deltas_t.numpy(), np.asarray(deltas),
                               rtol=1e-4, atol=1e-6)
    lr_j = float(OJ.group_lr(OJ.DEFAULT_GROUPS["means"], jnp.int32(step)))
    assert float(sched.rows([step])[0, 0]) == lr_j


# ------------------------------------------------------- bench_torch.py --

def test_bench_torch_smoke_on_cpu(tmp_path):
    """bench_torch.py --device cpu --smoke --seed 1 runs every phase at a
    toy size and prints one JSON line with the bench's keys, the seed and
    the quality horizon's 9-view PSNR and population."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu",
         "--smoke", "--seed", "1"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert out["metric"] == "train_iters_per_sec_9view_640x480_dn_splatter"
    assert out["unit"] == "iters/sec" and out["value"] > 0
    extra = out["extra"]
    for k in ("psnr_3000", "step_ms", "t_window_500_s", "t_window_2000_s",
              "peak_memory_gb", "graphs", "capture_s", "device_busy_share",
              "card", "roofline_frac", "num_gaussians", "scale",
              "measure_state_stable", "psnr_3000_views", "alive_3000"):
        assert k in extra, k
    assert extra["platform"] == "cpu" and extra["graphs"] == 0
    assert np.isfinite(extra["psnr_3000"])
    assert np.isfinite(extra["psnr_3000_views"]) and extra["alive_3000"] > 0
    assert extra["seed"] == 1
    assert extra["scale"]["num_gaussians"] > 0


def test_profiling_timers_and_trace(tmp_path):
    """utils/profiling.py: trace writes a Chrome trace and yields a profile
    whose CPU run has no device kernel and no launch call; a training
    step's spans come out in it as host records; host_calls counts every
    launch call of a profile."""
    from types import SimpleNamespace

    from fusionsense_tpu_torch.utils import profiling as PR

    with PR.trace(str(tmp_path / "tr")) as prof:
        with PR.span("fs.step", 0):
            torch.ones(64).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").exists()
    assert PR.device_time(prof)[:2] == (0.0, 0) and PR.host_calls(prof) == 0
    assert "fs.step" in (tmp_path / "tr" / "trace.json").read_text()
    rows = [SimpleNamespace(key=k, count=n) for k, n in
            (("cudaLaunchKernel", 5), ("cudaGraphLaunch", 2),
             ("cudaMemcpyAsync", 1), ("aten::mul", 9))]
    assert PR.host_calls(SimpleNamespace(key_averages=lambda: rows)) == 8
