"""The port's ADC refine (split / dup / cull / opacity reset, free-slot
allocation) against the JAX package's, on the cases of test_store_adc.py
and on random 4,096-slot states that set every mask. Both start from the
same numpy state; JAX's split normals go into the port through `noise`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusionsense_tpu.gaussians import adc as ADCJ
from fusionsense_tpu.gaussians.init import init_from_points as init_j
from fusionsense_tpu.train import optim as OJ
from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.gaussians import adc as ADCT


def jax_noise(key, n_split, capacity):
    """The normals JAX's refine draws for its split children."""
    keys = jax.random.split(key, max(n_split, 2))
    return np.stack([np.asarray(jax.random.normal(k, (capacity, 3)))
                     for k in keys])


def small_state(n=10, capacity=32, key=0):
    pts = jax.random.normal(jax.random.PRNGKey(key), (n, 3))
    rgb = jax.random.uniform(jax.random.PRNGKey(key + 1), (n, 3))
    return init_j(pts, rgb, capacity=capacity, sh_degree=1)


def _np(tree):
    return {k: np.asarray(v) for k, v in dict(tree).items()}


def _adam_np(opt):
    return {"m": _np(opt.m), "v": _np(opt.v), "acc": _np(opt.acc),
            "counts": _np(opt.counts)}


def run_both(state, opt, stats, cfg_kw, step, seed=0):
    """refine in both packages on the same state -> (jax out, torch out)."""
    key = jax.random.PRNGKey(seed)
    cfg_j = ADCJ.ADCConfig(**cfg_kw)
    out_j = jax.jit(ADCJ.refine, static_argnums=4)(state, opt, stats, key,
                                                   cfg_j, jnp.asarray(step))
    noise = jax_noise(key, cfg_j.n_split_samples, state.capacity)
    out_t = ADCT.refine(convert.state_from_numpy(_np(state), "cpu"),
                        convert.adam_from_numpy(_adam_np(opt), "cpu"),
                        convert.stats_from_numpy(_np(stats), "cpu"),
                        torch.tensor(noise), ADCT.ADCConfig(**cfg_kw), step)
    return out_j, out_t


def assert_refine_match(state, out_j, out_t):
    (gj, oj, sj, ij), (gt, ot, st, it) = out_j, out_t
    for k in ("culled", "split", "dupped", "alloc_dropped", "opacity_reset"):
        assert int(it[k]) == int(ij[k]), k
    gjn, gtn = _np(gj), {k: v.numpy() for k, v in gt.fields().items()}
    for k in ("alive", "frozen"):
        np.testing.assert_array_equal(gtn[k], gjn[k], err_msg=k)
    before = _np(state)
    for k in gtn:
        if k in ("alive", "frozen"):
            continue
        # which slots were written, exactly; then the values
        axes = tuple(range(1, before[k].ndim))
        wj = np.any(gjn[k] != before[k], axis=axes)
        wt = np.any(gtn[k] != before[k], axis=axes)
        np.testing.assert_array_equal(wt, wj, err_msg=k)
        np.testing.assert_allclose(gtn[k], gjn[k], atol=1e-6, rtol=0, err_msg=k)
    for tree in ("m", "v", "acc"):
        for k, v in getattr(ot, tree).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(getattr(oj, tree)[k]),
                                       atol=1e-6, rtol=0, err_msg=(tree, k))
    for k, v in st.fields().items():
        assert not np.any(v.numpy()), k                  # fresh stats
        assert v.dtype == (torch.int32 if k == "count" else torch.float32)


def _cull_low_opacity():
    s = small_state(10, 32)
    s = s.replace(logit_opacities=s.logit_opacities.at[0].set(-10.0))
    return s, OJ.init_adam(s.params()), ADCJ.init_stats(32), dict(
        warmup=0, refine_every=10, stop_split_at=100), 10


def _split_and_dup():
    s = small_state(10, 64)
    stats = ADCJ.init_stats(64)
    stats = stats.replace(
        grad2d_acc=stats.grad2d_acc.at[0].set(10.0).at[1].set(10.0),
        count=stats.count.at[0].set(1).at[1].set(1))
    s = s.replace(log_scales=s.log_scales.at[0].set(jnp.log(0.5))
                  .at[1].set(jnp.log(1e-4)))
    return s, OJ.init_adam(s.params()), stats, dict(
        warmup=0, refine_every=10, stop_split_at=100,
        densify_grad_thresh=0.01, densify_size_thresh=0.01,
        cull_alpha_thresh=0.01), 10


def _capacity_exhausted():
    s = small_state(10, 11)
    stats = ADCJ.init_stats(11).replace(grad2d_acc=jnp.full((11,), 10.0),
                                        count=jnp.ones((11,), jnp.int32))
    return s, OJ.init_adam(s.params()), stats, dict(
        warmup=0, refine_every=10, stop_split_at=100,
        densify_grad_thresh=0.01, cull_alpha_thresh=0.01), 10


def _frozen_untouched():
    s = small_state(10, 32)
    s = s.replace(frozen=s.frozen.at[3].set(True),
                  logit_opacities=s.logit_opacities.at[3].set(-10.0))
    stats = ADCJ.init_stats(32).replace(grad2d_acc=jnp.full((32,), 10.0),
                                        count=jnp.ones((32,), jnp.int32))
    return s, OJ.init_adam(s.params()), stats, dict(
        warmup=0, refine_every=10, stop_split_at=100,
        densify_grad_thresh=0.01), 10


def _opacity_reset():
    s = small_state(10, 32)
    s = s.replace(logit_opacities=jnp.full((32,), 3.0))
    opt = OJ.init_adam(s.params())
    opt.m["logit_opacities"] = jnp.ones((32,))
    return s, opt, ADCJ.init_stats(32), dict(
        warmup=0, refine_every=10, reset_alpha_every=1, stop_split_at=100,
        cull_alpha_thresh=0.1), 10


CASES = {"cull_low_opacity": _cull_low_opacity,
         "split_and_dup": _split_and_dup,
         "capacity_exhausted": _capacity_exhausted,
         "frozen_untouched": _frozen_untouched,
         "opacity_reset": _opacity_reset}


@pytest.mark.parametrize("name", sorted(CASES))
def test_refine_matches_jax(name):
    state, opt, stats, cfg_kw, step = CASES[name]()
    out_j, out_t = run_both(state, opt, stats, cfg_kw, step)
    assert_refine_match(state, out_j, out_t)
    g, _, _, info = out_t
    if name == "cull_low_opacity":
        assert not bool(g.alive[0]) and int(g.num_alive) == 9
    elif name == "split_and_dup":
        assert (int(info["split"]), int(info["dupped"])) == (1, 1)
        assert int(g.num_alive) == 12
        np.testing.assert_allclose(float(torch.exp(g.log_scales[0, 0])),
                                   0.5 / 1.6, rtol=1e-5)
    elif name == "capacity_exhausted":
        assert int(info["alloc_dropped"]) > 0 and int(g.num_alive) <= 11
    elif name == "frozen_untouched":
        assert bool(g.alive[3]) and bool(g.frozen[3])
        np.testing.assert_array_equal(g.means[3].numpy(),
                                      np.asarray(state.means[3]))
    else:
        assert bool(info["opacity_reset"])


def random_state(seed, capacity=4096, n_alive=3400, n_frozen=100):
    """Alive, frozen and free slots, opacities either side of the cull,
    scales either side of the split and cull sizes, and more densify
    requests than free slots."""
    rng = np.random.RandomState(seed)
    s = small_state(n_alive, capacity, key=seed)
    alive = np.zeros(capacity, bool)
    alive[rng.permutation(capacity)[:n_alive]] = True
    frozen = np.zeros(capacity, bool)
    frozen[rng.permutation(np.flatnonzero(alive))[:n_frozen]] = True
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    s = s.replace(
        means=f32(rng.normal(size=(capacity, 3))),
        quats=f32(rng.normal(size=(capacity, 4))),
        log_scales=f32(rng.uniform(np.log(1e-3), np.log(0.8), (capacity, 3))),
        logit_opacities=f32(rng.normal(1.5, 1.5, capacity)),
        features_dc=f32(rng.normal(size=(capacity, 3))),
        features_rest=f32(rng.normal(size=(capacity, 3, 3))),
        alive=jnp.asarray(alive), frozen=jnp.asarray(frozen))
    opt = OJ.init_adam(s.params())
    for tree in (opt.m, opt.v, opt.acc):
        for k, v in tree.items():
            tree[k] = f32(np.abs(rng.normal(size=v.shape)))
    stats = ADCJ.RefineStats(
        grad2d_acc=f32(rng.uniform(0, 0.05, capacity)),
        count=jnp.asarray(rng.randint(0, 4, capacity).astype(np.int32)),
        max_radius=f32(rng.uniform(0, 0.16, capacity)))
    return s, opt, stats


@pytest.mark.parametrize("n_split", [2, 3])
def test_refine_random_state_matches_jax(n_split):
    state, opt, stats = random_state(3 + n_split)
    # step 40: refine index 4 resets opacities, and it is past the first
    # reset, so oversized Gaussians are culled too
    cfg_kw = dict(warmup=0, refine_every=10, reset_alpha_every=2,
                  stop_split_at=100, n_split_samples=n_split)
    out_j, out_t = run_both(state, opt, stats, cfg_kw, 40, seed=11)
    assert_refine_match(state, out_j, out_t)
    info = out_t[3]
    for k in ("culled", "split", "dupped", "alloc_dropped"):
        assert int(info[k]) > 0, (k, {k: int(v) for k, v in info.items()})
    assert bool(info["opacity_reset"])


def test_split_noise_shape_device_and_seed():
    for n in (1, 2, 3):
        gen = torch.Generator(device="cpu").manual_seed(5)
        a = ADCT.split_noise(gen, n, 64, "cpu")
        assert a.shape == (max(n, 2), 64, 3) and a.device.type == "cpu"
        assert a.dtype == torch.float32
        b = ADCT.split_noise(torch.Generator().manual_seed(5), n, 64, "cpu")
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = ADCT.split_noise(torch.Generator().manual_seed(6), 2, 64, "cpu")
    assert not torch.equal(a[:2], c)
