"""The port's CUDA kernels against their plain versions, and the wrappers'
routing. Imports no JAX, so the card's tests run where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

The gpu-marked tests skip without a card (the card check is made inside a
fixture, never at import, so every test worker collects the same tests)."""
import numpy as np
import pytest
import torch

from flat_cases import (
    B, C, CASES, DENSE_CASES, DENSE_K, P, T, TILES_X, TS, case, dense_case,
    shard_case, torch_dense_fwd_bwd, torch_fwd_bwd,
)
from fusionsense_tpu_torch.kernels import build
from fusionsense_tpu_torch.render import composite2 as C2
from fusionsense_tpu_torch.render import flat_composite as FC


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def assert_columns_close(got, want, rel):
    """max |got - want| of each column within `rel` of the column's largest
    |want|: each gradient column is held at its own scale."""
    err = np.abs(got - want).max(axis=0)
    scale = np.abs(want).max(axis=0)
    assert np.all(err <= rel * scale), (err / np.maximum(scale, 1e-30)).tolist()


def finite_part(got, want):
    """Both with zeros where `want` is not finite, after checking that `got`
    has NaN only where `want` has: a warp whose pixels all have alpha = 0
    adds exact zeros in the kernels, where the plain version adds 0 * NaN
    once a NaN has entered the block's transmittance."""
    bad = ~np.isfinite(want)
    assert not np.isnan(got[~bad]).any()
    return np.where(bad, 0.0, got), np.where(bad, 0.0, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(card, name):
    tab, bt, _, bc, g_out, g_alpha = case(name)
    args = (tab, bt, bc, g_out, g_alpha)
    FC.reset_launch_counts()
    got = torch_fwd_bwd(*args, device=card)
    assert FC.LAUNCHES["flat_composite_fwd"] == 1
    assert FC.LAUNCHES["flat_composite_bwd"] == 1
    assert FC.LAUNCHES["flat_composite_fwd_plain"] == 0
    want = torch_fwd_bwd(*args, device="cpu")
    # K2 recovers T_excl by walking back from the block's exit log T, where
    # the plain version takes a forward cumsum, and sums over pixels in
    # another order. The saturated tile's wide Gaussians (sigma 12-20 px)
    # make the conic columns sums of large terms that cancel: there the two
    # differ by up to 9e-5 absolute, 5e-5 of the column's scale (H100), so
    # dtab is held both to 1e-4 absolute and to 1e-4 of each column's scale.
    # out and alpha have NaN exactly where the plain version has (the
    # culled_rows case), dtab NaN only there.
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert np.isnan(got[2]).any() == np.isnan(want[2]).any()
    dtab, dtab_want = finite_part(got[2], want[2])
    np.testing.assert_allclose(dtab, dtab_want, atol=1e-4, rtol=0)
    assert_columns_close(dtab, dtab_want, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_at_tile_lo_match_plain_on_card(card, name, n):
    """K1/K2 on a tile-sharded mesh's blocks (tile_lo = me * T_loc) against
    the plain versions at K1/K2's limits above; the shards' outputs,
    concatenated, against the unsharded kernel's."""
    full = torch_fwd_bwd(*(case(name)[i] for i in (0, 1, 3, 4, 5)),
                         device=card)
    outs = []
    for me in range(n):
        tab, bt, _, bc, g_o, g_a, lo, t_loc, _ = shard_case(name, n, me)
        args = (tab, bt, bc, g_o, g_a)
        kw = dict(num_tiles=t_loc, tile_lo=lo)
        FC.reset_launch_counts()
        got = torch_fwd_bwd(*args, device=card, **kw)
        assert FC.LAUNCHES["flat_composite_fwd"] == 1
        assert FC.LAUNCHES["flat_composite_fwd_plain"] == 0
        want = torch_fwd_bwd(*args, device="cpu", **kw)
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
        dtab, dtab_want = finite_part(got[2], want[2])
        np.testing.assert_allclose(dtab, dtab_want, atol=1e-4, rtol=0)
        assert_columns_close(dtab, dtab_want, 1e-4)
        outs.append(got[0])
    np.testing.assert_allclose(np.concatenate(outs)[:T], full[0], atol=1e-5,
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_kernels_at_offset_tile_ids_match_plain_on_card(card, name, n):
    """K3/K4 on a tile-sharded mesh's row blocks, each at its global tile
    ids (the sharded step's me * T_loc + arange(T_loc)), against the plain
    versions; the blocks' outputs, concatenated, against the whole
    table's."""
    tab, counts, tile_ids, g_out, g_alpha = dense_case(name)
    full = torch_dense_fwd_bwd(tab, counts, tile_ids, g_out, g_alpha,
                               device=card)
    t_loc = -(-T // n)
    outs = []
    for me in range(n):
        rows = slice(me * t_loc, min((me + 1) * t_loc, T))
        args = (tab[rows], counts[rows], tile_ids[rows], g_out[rows],
                g_alpha[rows])
        got = torch_dense_fwd_bwd(*args, device=card)
        want = torch_dense_fwd_bwd(*args, device="cpu")
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
        dtab, dtab_want = finite_part(got[2], want[2])
        np.testing.assert_allclose(dtab, dtab_want, atol=1e-4, rtol=0)
        outs.append(got[0])
    np.testing.assert_allclose(np.concatenate(outs), full[0], atol=1e-5,
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_stages_match_plain_on_card(card, name):
    """Each CUDA stage of K1/K2 against its plain twin on the same inputs,
    the kernels' own state passed along as chip_smoke.py does: the scan's
    carries, log T and live flags exactly, the rest at K1/K2's limits."""
    tab, bt, _, bc, g_out, g_alpha = case(name)
    g = torch.zeros((T + 1, C, P))
    g[:T] = torch.tensor(g_out).transpose(1, 2)
    g_logt = torch.zeros((T + 1, P))
    g_logt[:T] = -torch.tensor(g_alpha)
    table, count = torch.tensor(tab).to(card), torch.tensor(bc).to(card)
    runs = FC.tile_runs(torch.tensor(bt), T).to(card)
    geo = (TILES_X, TS, B)

    def both(stage, *args):
        """The stage's CUDA outputs and its twin's on CPU copies, as numpy."""
        got = getattr(FC, f"{stage}_cuda")(*args)
        torch.cuda.synchronize()
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        want = getattr(FC, f"{stage}_plain")(*cpu)
        pair = lambda k, p: (k.cpu().numpy(), p.numpy())  # noqa: E731
        if torch.is_tensor(got):
            return got, pair(got, want)
        return got, [pair(k, p) for k, p in zip(got, want)]

    (delta, acc, _, _), ((d, d_p), (a, a_p), (n, n_p), _) = both(
        "fwd_blocks", table, runs, count, *geo)
    np.testing.assert_allclose(np.exp(d), np.exp(d_p), atol=1e-6, rtol=0)
    np.testing.assert_allclose(a, a_p, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n, n_p)   # the kernel's cull is cull_rows
    (carry, live, logt), scanned = both("fwd_scan", delta, runs, count)
    for k, p in scanned:
        np.testing.assert_array_equal(k, p)
    _, (out, out_p) = both("fwd_combine", acc, carry, live, runs)
    np.testing.assert_allclose(out, out_p, atol=1e-5, rtol=0)
    g, g_logt = g.to(card), g_logt.to(card)
    S, (s, s_p) = both("bwd_suffix", acc, carry, live, runs, g)
    np.testing.assert_allclose(s, s_p, atol=1e-7, rtol=1e-5)
    _, (dtab, dtab_p) = both("bwd_blocks", table, runs, live, g, g_logt,
                             logt, carry, S, *geo)
    dtab, dtab_want = finite_part(dtab, dtab_p)
    np.testing.assert_allclose(dtab, dtab_want, atol=1e-4, rtol=0)
    assert_columns_close(dtab, dtab_want, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_kernels_match_plain_on_card(card, name):
    """K3/K4 against the plain versions, with the flat cases' limits; nused
    and the carries of the chunks composited too. out, alpha and log T
    have NaN exactly where the plain version has (the nan_past_stop case),
    dtab NaN only there."""
    args = dense_case(name)
    C2.reset_launch_counts()
    got = torch_dense_fwd_bwd(*args, device=card)
    assert C2.LAUNCHES["composite2_fwd"] == 1
    assert C2.LAUNCHES["composite2_bwd"] == 1
    assert C2.LAUNCHES["composite2_fwd_plain"] == 0
    want = torch_dense_fwd_bwd(*args, device="cpu")
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert np.isnan(got[2]).any() == np.isnan(want[2]).any()
    dtab, dtab_want = finite_part(got[2], want[2])
    np.testing.assert_allclose(dtab, dtab_want, atol=1e-4, rtol=0)
    assert_columns_close(dtab.reshape(-1, dtab.shape[-1]),
                         dtab_want.reshape(-1, dtab.shape[-1]), 1e-4)
    tab, counts, tile_ids = (torch.tensor(a) for a in args[:3])
    fwd_k = C2.composite2_fwd_cuda(*(x.to(card) for x in (tab, counts, tile_ids)),
                                   TILES_X, TS, B)
    fwd_p = C2.composite2_fwd_plain(tab, counts, tile_ids, TILES_X, TS, B)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(fwd_k[3].cpu().numpy(), fwd_p[3].numpy())
    np.testing.assert_allclose(fwd_k[1].cpu().numpy(), fwd_p[1].numpy(),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(fwd_k[2].cpu().numpy(), fwd_p[2].numpy(),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_stages_match_plain_on_card(card, name):
    """Each CUDA stage of K3/K4 against its plain twin on the same inputs,
    the kernels' own state passed along as chip_smoke.py does: delta and
    acc of the chunks below ceil(count / B) (the kernel writes no others),
    the combine's carries, log T and nused exactly (the same deltas summed
    in the same order), S of the chunks below nused, dtab at K4's limits."""
    tab, counts, tile_ids, g_out, g_alpha = dense_case(name)
    table, counts, ids = (torch.tensor(a).to(card)
                          for a in (tab, counts, tile_ids))
    g = torch.tensor(g_out).transpose(1, 2).contiguous().to(card)
    g_logt = (-torch.tensor(g_alpha)).to(card)
    geo = (TILES_X, TS, B)
    nc = DENSE_K // B

    def both(stage, *args):
        """The stage's CUDA outputs and its twin's on CPU copies."""
        got = getattr(C2, f"{stage}_cuda")(*args)
        torch.cuda.synchronize()
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        return got, getattr(C2, f"{stage}_plain")(*cpu)

    (delta, acc, _), (delta_p, acc_p, _) = both("fwd_chunks", table, counts,
                                                ids, *geo)
    done = (torch.arange(nc)[None, :]
            < C2.n_chunks(counts.cpu(), B, nc)[:, None])
    np.testing.assert_allclose(torch.exp(delta.cpu()[done]).numpy(),
                               torch.exp(delta_p[done]).numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(acc.cpu()[done].numpy(), acc_p[done].numpy(),
                               atol=1e-5, rtol=0)
    (out, logt, carries, nused), combined = both("fwd_combine", delta, acc,
                                                 counts, B)
    np.testing.assert_allclose(out.cpu().numpy(), combined[0].numpy(),
                               atol=1e-5, rtol=0)
    for k, p in zip((logt, carries, nused), combined[1:]):
        np.testing.assert_array_equal(k.cpu().numpy(), p.numpy())
    used = torch.arange(nc)[None, :] < nused.cpu()[:, None].long()
    S, S_p = both("bwd_suffix", acc, carries, nused, g)
    np.testing.assert_allclose(S.cpu()[used].numpy(), S_p[used].numpy(),
                               atol=1e-7, rtol=1e-5)
    dtab, dtab_p = both("bwd_chunks", table, nused, ids, g, g_logt, logt,
                        carries, S, *geo)
    dtab, dtab_want = finite_part(dtab.cpu().numpy(), dtab_p.numpy())
    np.testing.assert_allclose(dtab, dtab_want, atol=1e-4, rtol=0)
    assert_columns_close(dtab.reshape(-1, dtab.shape[-1]),
                         dtab_want.reshape(-1, dtab.shape[-1]), 1e-4)


def _refine_inputs(seed=3, capacity=4096, n_alive=3400):
    """A random store with every refine mask set (as in test_torch_adc.py),
    built with numpy only."""
    from fusionsense_tpu_torch import convert

    rng = np.random.RandomState(seed)
    alive = np.zeros(capacity, bool)
    alive[rng.permutation(capacity)[:n_alive]] = True
    frozen = np.zeros(capacity, bool)
    frozen[rng.permutation(np.flatnonzero(alive))[:100]] = True
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    state = convert.state_from_numpy({
        "means": f32(capacity, 3), "quats": f32(capacity, 4),
        "log_scales": rng.uniform(np.log(1e-3), np.log(0.8),
                                  (capacity, 3)).astype(np.float32),
        "logit_opacities": (1.5 + 1.5 * f32(capacity)),
        "features_dc": f32(capacity, 3), "features_rest": f32(capacity, 3, 3),
        "normals": f32(capacity, 3), "alive": alive, "frozen": frozen}, "cpu")
    params = state.params()
    opt = convert.adam_from_numpy({
        "m": {k: np.abs(f32(*v.shape)) for k, v in params.items()},
        "v": {k: np.abs(f32(*v.shape)) for k, v in params.items()},
        "acc": {k: f32(*v.shape) for k, v in params.items()},
        "counts": {k: np.int32(3) for k in params}}, "cpu")
    stats = convert.stats_from_numpy({
        "grad2d_acc": rng.uniform(0, 0.05, capacity).astype(np.float32),
        "count": rng.randint(0, 4, capacity).astype(np.int32),
        "max_radius": rng.uniform(0, 0.16, capacity).astype(np.float32)}, "cpu")
    return state, opt, stats


def _to(obj, device):
    """A GaussianState / AdamState / RefineStats with every tensor moved."""
    import dataclasses

    return type(obj)(**{f.name: (
        {k: v.to(device) for k, v in getattr(obj, f.name).items()}
        if isinstance(getattr(obj, f.name), dict)
        else getattr(obj, f.name).to(device)) for f in dataclasses.fields(obj)})


def _assert_state_close(got, want, atol=1e-6):
    for k, v in want.fields().items():
        g = getattr(got, k).cpu()
        if v.dtype == torch.bool:
            assert torch.equal(g, v), k
        else:
            torch.testing.assert_close(g, v, atol=atol, rtol=0, msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [2, 3])
def test_refine_on_card_matches_cpu(card, n_split):
    """refine on the card (argsort, cumsum ranks, masked slot writes) equals
    refine on the CPU for the same split normals."""
    from fusionsense_tpu_torch.gaussians import adc

    cfg = adc.ADCConfig(warmup=0, refine_every=10, reset_alpha_every=2,
                        stop_split_at=100, n_split_samples=n_split)
    state, opt, stats = _refine_inputs()
    noise = adc.split_noise(torch.Generator().manual_seed(1), n_split,
                            state.capacity, "cpu")
    want = adc.refine(state, opt, stats, noise, cfg, 40)
    got = adc.refine(_to(state, card), _to(opt, card), _to(stats, card),
                     noise.to(card), cfg, 40)
    for k in want[3]:
        assert int(got[3][k]) == int(want[3][k]), k
    assert int(want[3]["alloc_dropped"]) > 0 and int(want[3]["split"]) > 0
    _assert_state_close(got[0], want[0])
    for tree in ("m", "v", "acc"):
        for k, v in getattr(want[1], tree).items():
            torch.testing.assert_close(getattr(got[1], tree)[k].cpu(), v,
                                       atol=1e-6, rtol=0)
    gen = torch.Generator(device=card).manual_seed(5)
    drawn = adc.split_noise(gen, n_split, 64, card)
    assert drawn.device.type == "cuda" and drawn.shape == (max(n_split, 2), 64, 3)


@pytest.mark.gpu
def test_touch_on_card_matches_cpu(card):
    """add_touch_patches and touch_prune on the card equal the CPU's."""
    from fusionsense_tpu_torch.data.synthetic import sphere_touch_patches
    from fusionsense_tpu_torch.gaussians import touch

    patches = sphere_touch_patches(n_patches=4, pts_per_patch=100)
    state, opt, _ = _refine_inputs(seed=4)
    # half the live Gaussians on the sphere, so the boxes catch intruders
    state.means[::2] = 0.5 * torch.nn.functional.normalize(state.means[::2],
                                                           dim=-1)
    want = touch.add_touch_patches(state, opt, patches, gel_scale=0.01)
    got = touch.add_touch_patches(_to(state, card), _to(opt, card), patches,
                                  gel_scale=0.01)
    _assert_state_close(got[0], want[0])
    for tree in ("m", "v", "acc"):
        for k, v in getattr(want[1], tree).items():
            assert torch.equal(getattr(got[1], tree)[k].cpu(), v), (tree, k)
    assert int(want[0].frozen.sum()) == 100 + 400
    pruned = touch.touch_prune(got[0], got[2])
    assert torch.equal(pruned.alive.cpu(), touch.touch_prune(want[0],
                                                             want[2]).alive)


def _fused_trainer(device, backend, stop_split_at=150, camera_opt=False,
                   sdf=False):
    """test_train_e2e.py:289's run_fused setting, built with the port alone
    on `device`: 4 views at 64x48, tile 16, refines at every 50 steps from
    50, the adaptive policies held still; the flat backend rebins each view
    every 9 steps. Options: camera optimisation (Adam every 10 steps), the
    SDF loss (its draw inside the step)."""
    import dataclasses

    from fusionsense_tpu_torch import config as CF
    from fusionsense_tpu_torch.data import synthetic as SYN
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig
    from fusionsense_tpu_torch.gaussians.init import init_from_points
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render.rasterize import (
        RasterizeConfig, rasterize,
    )
    from fusionsense_tpu_torch.train.trainer import TrainData, Trainer

    cams = SYN.ring_cameras(n_views=4, width=64, height_px=48, focal=60.0,
                            device=device)
    pts, rgb, nrm = SYN.sphere_points(n=400, radius=0.5, device=device)
    gt = init_from_points(pts, rgb, capacity=512, sh_degree=1,
                          seed_normals=nrm, init_opacity=0.95)
    rc = RasterizeConfig(tile_size=16, tile_capacity=128,
                         max_tiles_per_gaussian=8, tile_chunk=12, sh_degree=1,
                         backend=backend)
    imgs, deps, nms = [], [], []
    with torch.no_grad():
        for i in range(4):
            out = rasterize(*activated(gt), cams.index(i),
                            dataclasses.replace(rc, tile_capacity=512),
                            device=device)
            d, n, _ = SYN.sphere_depth_normals(cams.index(i))
            imgs.append(out.rgb)
            deps.append(d)
            nms.append(n)
    data = TrainData(images=torch.stack(imgs), sensor_depths=torch.stack(deps),
                     normals=torch.stack(nms))
    p2, r2, _ = SYN.sphere_points(n=150, radius=0.5, device=device)
    cfg = CF.ExperimentConfig(
        model=CF.ModelConfig(sh_degree=1, rasterize=rc, capacity=1024,
                             binary_opacities=False),
        train=CF.TrainConfig(
            iterations=150, scan_chunk=50, log_every=50, auto_capacity=False,
            auto_tile_capacity=False, auto_cover_window=False,
            bin_refresh_steps=9, camera_opt=camera_opt,
            camera_opt_every_k=10,
            adc=ADCConfig(warmup=50, refine_every=50,
                          stop_split_at=stop_split_at,
                          densify_grad_thresh=1e-5, cull_alpha_thresh=0.05)),
        loss=CF.LossConfig(normal_lambda=0.1, sensor_depth_lambda=0.2,
                           smooth_lambda=0.0, flatness_lambda=0.01,
                           sdf_lambda=0.1 if sdf else 0.0, sdf_samples=128))
    init = init_from_points(p2, r2, capacity=1024, sh_degree=1,
                            generator=torch.Generator().manual_seed(0))
    return lambda: Trainer(cfg, cams, data, init.replace(
        **{k: v.clone() for k, v in init.fields().items()}), device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("backend,extras", [
    ("flat", False), ("pallas", False), ("pallas", True), ("jax", False)])
def test_fused_graphs_match_eager_on_card(card, backend, extras):
    """Two intervals of 50 as CUDA graph replays (a refine at 50 between
    them) against Trainer.run over the same steps: n_alive and the alive
    mask equal, means within rtol 1e-4 / atol 1e-5, PSNR within 0.05, and
    the kernels launched once per step inside the replays. `extras` adds
    camera optimisation and the SDF loss, whose draw runs inside the
    replays."""
    from fusionsense_tpu_torch.train import graphs as G

    make = _fused_trainer(card, backend, camera_opt=extras, sdf=extras)
    tr_a = make()
    tr_a.run(iterations=100, log=None)
    tr_b = make()
    G.reset_launch_counts()
    n = tr_b.sync_policies(tr_b.run_fused(2, interval=50))
    assert tr_b.step == 100 and n == int(tr_a.gaussians.num_alive)
    assert torch.equal(tr_a.gaussians.alive, tr_b.gaussians.alive)
    torch.testing.assert_close(tr_b.gaussians.means, tr_a.gaussians.means,
                               rtol=1e-4, atol=1e-5)
    assert abs(tr_a.history[-1]["psnr"] - tr_b.history[-1]["psnr"]) < 0.05
    if extras:
        torch.testing.assert_close(tr_b.cam_state[0], tr_a.cam_state[0],
                                   rtol=1e-4, atol=1e-6)
    stats = tr_b.graph_stats()
    # one graph per rebin decision of the flat bin cache, one without it
    assert stats["replays"] == 100
    assert stats["graphs"] == (2 if backend == "flat" else 1)
    if backend != "jax":     # the jax backend launches no kernel of ours
        key = "flat_composite" if backend == "flat" else "composite2"
        assert G.REPLAYED[f"{key}_fwd"] >= 100
        assert G.REPLAYED[f"{key}_bwd"] >= 100
    # every backend's loss runs the SSIM pair once a step
    assert G.REPLAYED["ssim_fwd"] == G.REPLAYED["ssim_bwd"] == 100
    assert G.pool_bytes(tr_b._graph_pool)[0] == 0


@pytest.mark.gpu
def test_graph_replay_draws_what_the_eager_step_draws(card):
    """The SDF draw inside a captured step: with the generator registered
    with the graph and seeded with the step before each replay, a replay
    draws exactly what a fresh generator seeded with that step draws (the
    eager step's draw), in any order, the replay that follows the capture
    included (the capture's warm-up must not move the generator)."""
    from fusionsense_tpu_torch.train.graphs import StepGraphs
    from fusionsense_tpu_torch.train.sdf_loss import (
        sample_points_in_gaussians,
    )

    rng = np.random.RandomState(0)
    f32 = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32), device=card)
    args = (f32(500, 3), f32(500, 4), torch.exp(f32(500, 3) - 3),
            torch.tensor(rng.uniform(size=500) > 0.2, device=card))
    gen = torch.Generator(card)
    out_p = torch.zeros((256, 3), device=card)
    out_i = torch.zeros((256,), dtype=torch.int64, device=card)

    def body(commit):
        p, i = sample_points_in_gaussians(gen, *args, 256)
        if commit:
            out_p.copy_(p)
            out_i.copy_(i)

    graphs = StepGraphs(torch.cuda.graph_pool_handle(), gen)
    for step in (3, 7, 3, 11):
        gen.manual_seed(step)
        graphs.run("draw", body)
        want_p, want_i = sample_points_in_gaussians(
            torch.Generator(card).manual_seed(step), *args, 256)
        assert torch.equal(out_i, want_i) and torch.equal(out_p, want_p), step
    assert len(graphs.graphs) == 1 and graphs.replays == 4


@pytest.mark.gpu
def test_step_and_fused_interval_make_no_host_sync(card):
    """torch.cuda.set_sync_debug_mode("error") around one eager step and
    around one fused interval whose end refines and compacts."""
    from fusionsense_tpu_torch.train.trainer import patched_cfg, train_step

    tr = _fused_trainer(card, "flat", stop_split_at=1000)()
    tr.run(iterations=50, log=None)
    tr.run_fused(1, interval=50)          # captures the graphs
    cfg = patched_cfg(tr.cfg, tr.tile_capacity, tr.cover_tiles)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(tr.gaussians, tr.opt, tr.cam_state, tr.stats, tr.step, 0,
                   cfg=cfg, camera=tr.camera, data=tr.data,
                   render_n=tr.render_n)
        tr.run_fused(1, interval=50)      # refine and compaction at 150
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tr.step == 150


# the blend_bf16 branch (ROADMAP N5) on the card against the plain twins
# on the CPU, at the float32 limits of the tests above. The kernel and the
# twin each round w after forming it from alpha and a prefix sum whose last
# bits they compute in their own order, so a w near a rounding boundary can
# land on the neighbouring bf16 value. So at most BF16_FLIP_FRAC of the
# elements of out and of dtab may pass the float32 limit, none by more than
# one bf16 ulp (2^-8) of a unit channel or of the column's scale; and the
# float32 kernel must lie at least BF16_SEEN times farther from the twin in
# mean |d| (in every column of dtab). chip_smoke.py's rule, with a share
# and a factor sized for these small cases (one flipped element of out is
# 1/12,288 of it).
BF16_ULP, BF16_FLIP_FRAC, BF16_SEEN = 4e-3, 1e-2, 4.0


def assert_bf16_close(got, want, f32, limit, columns=False):
    """got (the bf16 kernel's) against want (the bf16 twin's) by the rule
    above, f32 the float32 kernel's on the same inputs; |d| absolute, or
    over each column's (last dimension's) max |want| with `columns`."""
    width = got.shape[-1] if columns else 1
    got, want, f32 = (np.reshape(x, (-1, width)) for x in (got, want, f32))
    f32 = np.where(np.isfinite(want), f32, 0.0)
    got, want = finite_part(got, want)
    scale = np.abs(want).max(axis=0) if columns else np.ones(1)
    scale = np.maximum(scale, 1e-30)
    d, d32 = np.abs(got - want) / scale, np.abs(f32 - want) / scale
    assert (d > limit).mean() <= BF16_FLIP_FRAC, (d > limit).mean()
    assert d.max() <= BF16_ULP, d.max()
    seen = d32.mean(axis=0) / np.maximum(d.mean(axis=0), 1e-30)
    assert np.all(seen >= BF16_SEEN), seen.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_kernels_match_plain_on_card(card, name):
    tab, bt, _, bc, g_out, g_alpha = case(name)
    args = (tab, bt, bc, g_out, g_alpha)
    FC.reset_launch_counts()
    got = torch_fwd_bwd(*args, device=card, blend_bf16=True)
    assert FC.LAUNCHES["flat_composite_fwd"] == 1
    assert FC.LAUNCHES["flat_composite_bwd"] == 1
    want = torch_fwd_bwd(*args, device="cpu", blend_bf16=True)
    f32 = torch_fwd_bwd(*args, device=card)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert np.isnan(got[2]).any() == np.isnan(want[2]).any()
    assert_bf16_close(got[0], want[0], f32[0], 1e-5)
    assert_bf16_close(got[2], want[2], f32[2], 1e-4, columns=True)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_bf16_dense_kernels_match_plain_on_card(card, name):
    args = dense_case(name)
    C2.reset_launch_counts()
    got = torch_dense_fwd_bwd(*args, device=card, blend_bf16=True)
    assert C2.LAUNCHES["composite2_fwd"] == 1
    assert C2.LAUNCHES["composite2_bwd"] == 1
    want = torch_dense_fwd_bwd(*args, device="cpu", blend_bf16=True)
    f32 = torch_dense_fwd_bwd(*args, device=card)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert np.isnan(got[2]).any() == np.isnan(want[2]).any()
    assert_bf16_close(got[0], want[0], f32[0], 1e-5)
    assert_bf16_close(got[2], want[2], f32[2], 1e-4, columns=True)


def test_cpu_tensors_take_the_plain_version():
    FC.reset_launch_counts()
    tab, bt, _, bc, g_out, g_alpha = case("mixed")
    torch_fwd_bwd(tab, bt, bc, g_out, g_alpha)
    assert FC.LAUNCHES == {"flat_composite_fwd": 0, "flat_composite_bwd": 0,
                           "flat_composite_fwd_plain": 1,
                           "flat_composite_bwd_plain": 1}


def test_dense_cpu_tensors_take_the_plain_version():
    C2.reset_launch_counts()
    torch_dense_fwd_bwd(*dense_case("mixed"))
    assert C2.LAUNCHES == {"composite2_fwd": 0, "composite2_bwd": 0,
                           "composite2_fwd_plain": 1,
                           "composite2_bwd_plain": 1}


def test_dense_kernel_wrappers_refuse_what_they_cannot_take():
    """No fallback: CPU tensors, a chunk that does not divide K, a channel
    count other than 8 and wrong index types all raise before a launch."""
    tab, counts, tile_ids, _, _ = dense_case("mixed")
    tab, counts, tile_ids = (torch.tensor(a) for a in (tab, counts, tile_ids))
    C2.reset_launch_counts()
    bad = [(tab, counts, tile_ids, B), (tab[:, :200], counts, tile_ids, B),
           (tab[..., :12], counts, tile_ids, B),
           (tab, counts.long(), tile_ids, B)]
    for t, c, i, b in bad:
        with pytest.raises(ValueError):
            C2.composite2_fwd_cuda(t, c, i, TILES_X, TS, b)
    with pytest.raises(ValueError):
        C2.composite2_fwd_plain(tab[:, :200], counts, tile_ids, TILES_X, TS, B)
    assert C2.LAUNCHES["composite2_fwd"] == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrapper raises on what its kernel cannot take."""
    tab, bt, _, bc, _, _ = case("mixed")
    runs = FC.tile_runs(torch.tensor(bt), T)
    with pytest.raises(ValueError):
        FC.flat_composite_fwd_cuda(torch.tensor(tab), runs, torch.tensor(bc),
                                   T, TILES_X, TS, B)
    assert FC.LAUNCHES["flat_composite_fwd"] == 0


def test_stage_wrappers_refuse_cpu_tensors():
    """Every CUDA stage of K1/K2 and of K3/K4 raises on CPU tensors before a
    launch."""
    tab, bt, _, bc, _, _ = case("mixed")
    table, count = torch.tensor(tab), torch.tensor(bc)
    runs = FC.tile_runs(torch.tensor(bt), T)
    delta, acc, _, _ = FC.fwd_blocks_plain(table, runs, count, TILES_X, TS, B)
    carry, live, logt = FC.fwd_scan_plain(delta, runs, count)
    g = torch.zeros((T + 1, C, P))
    S = FC.bwd_suffix_plain(acc, carry, live, runs, g)
    tab_d, counts, ids, _, _ = (torch.tensor(a) for a in dense_case("mixed"))
    delta_d, acc_d, _ = C2.fwd_chunks_plain(tab_d, counts, ids, TILES_X, TS, B)
    _, logt_d, carries, nused = C2.fwd_combine_plain(delta_d, acc_d, counts, B)
    g_d = torch.zeros((T, C, P))
    S_d = C2.bwd_suffix_plain(acc_d, carries, nused, g_d)
    calls = [
        (FC.fwd_blocks_cuda, (table, runs, count, TILES_X, TS, B)),
        (FC.fwd_scan_cuda, (delta, runs, count)),
        (FC.fwd_combine_cuda, (acc, carry, live, runs)),
        (FC.bwd_suffix_cuda, (acc, carry, live, runs, g)),
        (FC.bwd_blocks_cuda, (table, runs, live, g, logt, logt, carry, S,
                              TILES_X, TS, B)),
        (FC.flat_composite_bwd_cuda, (table, runs, g, logt, logt, carry, acc,
                                      live, TILES_X, TS, B)),
        (C2.fwd_chunks_cuda, (tab_d, counts, ids, TILES_X, TS, B)),
        (C2.fwd_combine_cuda, (delta_d, acc_d, counts, B)),
        (C2.bwd_suffix_cuda, (acc_d, carries, nused, g_d)),
        (C2.bwd_chunks_cuda, (tab_d, nused, ids, g_d, logt_d, logt_d, carries,
                              S_d, TILES_X, TS, B)),
        (C2.composite2_bwd_cuda, (tab_d, nused, ids, g_d, logt_d, logt_d,
                                  carries, acc_d, TILES_X, TS, B)),
    ]
    FC.reset_launch_counts()
    C2.reset_launch_counts()
    for fn, args in calls:
        with pytest.raises(ValueError):
            fn(*args)
    assert sum(FC.LAUNCHES.values()) == 0
    assert sum(C2.LAUNCHES.values()) == 0


def test_build_is_keyed_by_source_and_lazy():
    """Importing the loader builds nothing; targets live under build/."""
    so = build._target("flat_composite")
    assert so.parent == build.BUILD_DIR and so.suffix == ".so"
    assert "build" in so.parts and so.name.startswith("flat_composite-")
    assert (build.CSRC / "flat_composite.cu").exists()
    assert build.load.cache_info().currsize == 0


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """Every source is listed, each build input is found, and editing a
    header that a source includes changes that source's build key (and
    only that of the sources that include it)."""
    assert set(build.SOURCES) == {"flat_composite", "composite2",
                                  "preprocess", "ssim"}
    header = "composite_common.cuh"
    sharing = ("flat_composite", "composite2")
    for name in build.SOURCES:
        names = [p.name for p in build._inputs(name)]
        assert names == [f"{name}.cu", header if name in sharing
                         else f"{name}.cuh"]
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    (tmp_path / "lone.cu").write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._target(n) for n in build.SOURCES + ("lone",)}
    with open(tmp_path / header, "a") as f:
        f.write("// edited\n")
    after = {n: build._target(n) for n in build.SOURCES + ("lone",)}
    assert all(before[n] != after[n] for n in sharing)
    assert before["preprocess"] == after["preprocess"]
    assert before["ssim"] == after["ssim"]
    assert before["lone"] == after["lone"]


def test_launch_counts_are_kept_in_one_registry(monkeypatch):
    """Each kernel module keeps its counts in one build.Launches, and the
    CUDA graphs read every module's captured counts from the registry."""
    from fusionsense_tpu_torch.render import preprocess as PP
    from fusionsense_tpu_torch.train import graphs as G
    from fusionsense_tpu_torch.train import ssim_kernels as SK

    mods = (FC, C2, PP, SK)
    assert {id(m._COUNTS) for m in mods} <= {id(c) for c in build.REGISTRY}
    for m in mods:
        assert m.LAUNCHES is m._COUNTS.counts
        assert m.CAPTURED is m._COUNTS.captured
        assert set(m.CAPTURED) < set(m.LAUNCHES)
    assert set(G._captured()) == {k for m in mods for k in m.CAPTURED}
    SK.reset_launch_counts()
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setitem(SK.CAPTURED, "ssim_bwd", 0)
    SK._count("ssim_fwd")
    capturing[0] = True
    SK._count("ssim_bwd")
    assert SK.LAUNCHES == {"ssim_fwd": 1, "ssim_bwd": 0, "ssim_plain": 0}
    assert SK.CAPTURED["ssim_bwd"] == 1
    SK.reset_launch_counts()
    assert set(SK.LAUNCHES.values()) == {0}
    G.reset_launch_counts()
    assert G.REPLAYED == dict.fromkeys(G._captured(), 0)


CHECKED = {   # build.check's refusals: (dtype, shape wanted, tensor)
    "dtype": (torch.float32, (2, 3), torch.zeros((2, 3), dtype=torch.int32)),
    "not_contiguous": (torch.float32, (3, 2), torch.zeros((2, 3)).t()),
    "shape": (torch.float32, (2, 3), torch.zeros((3, 2))),
    "one_element": (torch.float32, None, torch.zeros((2,))),
    "other_device": (torch.float32, (2, 3),
                     torch.zeros((2, 3), device="meta")),
    "cpu": (torch.float32, None, torch.zeros(())),
}


@pytest.mark.parametrize("name", sorted(CHECKED))
def test_check_refuses_what_the_kernels_cannot_take(name):
    """build.check, which every kernel wrapper calls before a launch: CPU
    tensors fail last, after every other test has passed."""
    dtype, shape, t = CHECKED[name]
    with pytest.raises(ValueError) as e:
        build.check(torch.device("cpu"), ("x", t, dtype, shape))
    cpu = str(e.value) == "the kernels take CUDA tensors, got cpu"
    assert cpu == (name == "cpu")
