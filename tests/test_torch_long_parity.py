"""Long-run training parity at a small size: tests/torch_long_parity.py's
lockstep mode (the port drawing JAX's split normals) on bench.py's scene
cut to 80x60 with 2,000 GT / 1,000 init points and capacity 2^11, through a
scaled ADC schedule: refines every 20 steps from step 20 to 120, the
opacity reset at step 80, the world-scale cull opening after it (refine
100), the screen-size split and cull ending at stop_screen_size_at = 110
(after refine 100, so the screen cull fires once), splits and dups at four
refines or more. densify_grad_thresh, densify_size_thresh,
cull_scale_thresh and cull_screen_size are scaled to the small size so
that every one of those gates acts. The store stays in its capacity
bucket: a bucket grown past a full store is ROADMAP F10, where the JAX
trainer's steps turn non-finite (test_zero_quaternion_gradient below).

At this size the harness measured both paths exact through step 120: the
population, capacity, render prefix, pair budget, cover window, the
policies' telemetry and each refine's counts by cause equal at every
boundary, the 9-view mean PSNR within 1e-4 dB. So every boundary is held
exactly here, the PSNR within 1e-3 relative. Each case took 59 s (run) and
80 s (fused) in one process on an 8-core CPU host with four other runs
beside it: the port's plain K1/K2 twins about 45 s of each, and XLA's
compiles of three policy keys' programs about 35 s (the refine's debug
callback keeps the fused ones out of the persistent cache)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_long_parity as LP

S = LP.scene_spec(80, capacity=1 << 11, every=20, log_every=20,
                  scan_chunk=20)
ADC = dict(warmup=20, refine_every=20, reset_alpha_every=3,
           stop_screen_size_at=110, densify_grad_thresh=1.5e-3,
           densify_size_thresh=0.025, cull_scale_thresh=0.04,
           cull_screen_size=0.08)
STEPS = 120
EXACT = ("num_gaussians", "capacity", "render_n", "tile_capacity",
         "cover_tiles", "tile_overflow", "pairs_used", "trunc_by_win",
         "nonfinite_steps")
COUNTS = ("cull_opacity", "cull_world", "cull_screen", "culled", "split",
          "dupped")


@pytest.fixture(scope="module")
def scene():
    return LP.scene_numpy(S)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", ["run", "fused"])
def test_lockstep_matches_jax_through_the_schedule(scene, one_thread, path):
    rows = LP.run("lockstep", path, S, STEPS, adc=ADC, scene=scene)
    assert [r["step"] for r in rows] == list(range(20, STEPS + 1, 20))
    refines = {x["refine_step"]: x for r in rows for x in r["jax"]["refines"]}
    assert sorted(refines) == list(range(20, STEPS + 1, 20))

    # the schedule: splits and dups, the population moving, the reset at
    # 80, the world-scale cull from 100, the screen-size cull at 100 only
    assert sum(x["split"] > 0 and x["dupped"] > 0
               for x in refines.values()) >= 4
    assert len({r["jax"]["num_gaussians"] for r in rows}) >= 5
    by_step = {r["step"]: r for r in rows}
    assert by_step[80]["jax"]["max_opacity"] <= 2 * 0.1 + 1e-6
    assert by_step[60]["jax"]["max_opacity"] > 0.3
    assert all(refines[s]["cull_world"] == 0 for s in (20, 40, 60, 80))
    assert refines[100]["cull_world"] > 0 and refines[120]["cull_world"] > 0
    assert all(refines[s]["cull_screen"] == 0 for s in (20, 40, 60, 80, 120))
    assert refines[100]["cull_screen"] > 0

    # the port against JAX: every boundary exactly, PSNR to 1e-3 relative
    for r in rows:
        j, t = r["jax"], r["torch"]
        for k in EXACT:
            assert t[k] == j[k], (path, r["step"], k, t[k], j[k])
        assert [{k: x[k] for k in COUNTS} for x in t["refines"]] == [
            {k: x[k] for k in COUNTS} for x in j["refines"]], (path, r["step"])
        np.testing.assert_allclose(t["psnr_views"], j["psnr_views"],
                                   rtol=1e-3)
        np.testing.assert_allclose(t["psnr"], j["psnr"], rtol=1e-3)
        assert all(f["flips"] == 0 for f in r["refine_flips"]), r["step"]
    assert rows[-1]["agree"] >= 0.9


def test_zero_quaternion_gradient():
    """ROADMAP F10: jnp.linalg.norm's gradient at a zero vector is NaN,
    torch.linalg.norm's is 0. resize_train_state pads a grown store with
    zero quaternions, so once the render prefix reaches past the alive
    slots of a store that was full, the JAX step's quaternion gradient is
    NaN, its non-finite guard skips every step and the JAX trainer stops
    training; the port's gradient there is finite and it trains on."""
    from fusionsense_tpu.core.transforms import quat_to_rotmat as rot_j
    from fusionsense_tpu_torch.core.transforms import quat_to_rotmat as rot_t

    q = np.zeros((3, 4), np.float32)
    q[0] = [0.9, 0.1, -0.3, 0.2]
    w = np.random.RandomState(0).normal(size=(3, 3, 3)).astype(np.float32)
    w[1:] = 0          # a dead slot adds nothing to the loss
    gj = np.asarray(jax.grad(lambda x: jnp.sum(rot_j(x) * w))(jnp.asarray(q)))
    qt = torch.tensor(q, requires_grad=True)
    torch.sum(rot_t(qt) * torch.tensor(w)).backward()
    assert np.isnan(gj[1:]).all() and np.isfinite(gj[0]).all()
    assert torch.equal(qt.grad[1:], torch.zeros(2, 4))
    np.testing.assert_allclose(qt.grad[0].numpy(), gj[0], rtol=1e-5,
                               atol=1e-6)
