"""Long-run training parity: the port's Trainer against the JAX package's on
bench.py's schedule, boundary by boundary, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_long_parity.py lockstep \\
        --path fused --steps 4000 --out build/long_parity/lock_fused.jsonl
    JAX_PLATFORMS=cpu python tests/torch_long_parity.py free \\
        --package jax --seed 3 --out build/long_parity/free_jax_3.jsonl
    JAX_PLATFORMS=cpu python tests/torch_long_parity.py envelope \\
        build/long_parity/free_jax_*.jsonl \\
        --out tests/torch_long_parity_jax.json
    JAX_PLATFORMS=cpu python tests/torch_long_parity.py check \\
        build/long_parity/free_torch_*.jsonl

The scene is bench.py's (bench.py:179-245) with these cuts:
  * 160x120 pixels (640x480 in the bench), focal 550 * 160 / 640 = 137.5;
    `--size 320` is 320x240 with 12,000 / 6,000 points;
  * 6,000 GT sphere points (60,000) and 3,000 init points (30,000), the
    init perturbed by 0.02 * RandomState(0) normals as the bench does;
  * tile 16 (32) and capacity 2^14 (2^17);
  * 4,000 steps (bench: 3,000 to its quality horizon, then its windows);
    `--size 80` (80x60, 2,000 / 1,000 points) is the size of
    tests/test_torch_long_parity.py, with `--capacity`, `--every` (the
    boundary and log interval) and `--adc` (ADCConfig fields as JSON) for
    its scaled schedule.
Everything else is the bench's: 9 ring views, ADCConfig() defaults,
LossConfig(), bin_refresh_steps 18, the flat backend, an initial pair
budget of 512, binary_opacities off, scan_chunk 50, logs every 100 steps.

Both trainers start from one numpy state (init_from_points and the GT
renders made once by JAX, handed to the port through convert.py). Modes:
  * lockstep: both packages in one process, the port drawing JAX's split
    normals (and its SDF samples when sdf_lambda > 0), so every step's
    random input is the same; each row also holds the share of slots alive
    in both whose parameters all agree to 1e-4 + 1e-3 |x|;
  * control: JAX against JAX started from the same state with every float
    parameter moved by about one float32 rounding (`perturbed`): how far
    float order alone carries a trajectory, the yardstick for lockstep;
  * free: one package with its own generators and TrainConfig.seed.
`report` prints a lockstep or control file one line a boundary, with its
first divergence. Paths: `run` (Trainer.run to each boundary) and `fused` (run_fused of one
refine interval, then sync_policies, as bench.py's quality horizon does
with 500-step segments; here the policies tick every 100 steps, as
Trainer.run's log boundaries do).

Every boundary (every 100 steps) writes one JSON row per package: the
population, capacity bucket, render prefix, pair budget and cover window,
the telemetry the policies read (tile_overflow, trunc_by_win, pairs_used),
the logged loss and step PSNR (one view at one step), and psnr_views: the
mean PSNR of the 9 views, each package rendering its own state with its own
rasterizer. Each refine in the interval adds its counts by cause and the
opacities near cull_alpha_thresh (refine_diag).

The quality criterion (PERF.md section 2): at each boundary the port's
seed-mean of num_gaussians and of psnr_views lies within the JAX seeds'
mean +- max(2 x their sample standard deviation, 2% of alive / 0.1 dB)
(`envelope`, `check_envelope`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

SIZES = {
    80: dict(width=80, height=60, n_gt=2_000, n_init=1_000),
    160: dict(width=160, height=120, n_gt=6_000, n_init=3_000),
    320: dict(width=320, height=240, n_gt=12_000, n_init=6_000),
}
SCENE = dict(n_views=9, tile=16, capacity=1 << 14, tile_capacity=512,
             bin_refresh=18, scan_chunk=50, log_every=100, every=100)
ALIVE_FLOOR, PSNR_FLOOR = 0.02, 0.1     # the envelope's least half-widths
AGREE_ATOL, AGREE_RTOL = 1e-4, 1e-3
NEAR_BAND, NEAR_BINS, NEAR_LOGIT = 1e-2, 10, 1e-6


def scene_spec(size: int = 160, **over) -> dict:
    return {**SCENE, **SIZES[size], **over}


# --------------------------------------------------------------- scene ----

def scene_numpy(S: dict, cache: str | None = None):
    """(data, init): numpy dicts of the training views (GT rendered by JAX,
    its pair budget grown on overflow as bench.py grows it) and of the
    initial GaussianState. With `cache`, an .npz file: read when it exists,
    else written, so runs in several processes start from one scene."""
    if cache and Path(cache).exists():
        with np.load(cache) as z:
            return ({k[5:]: z[k] for k in z.files if k.startswith("data/")},
                    {k[5:]: z[k] for k in z.files if k.startswith("init/")})
    data, init = _build_scene(S)
    if cache:
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        np.savez(cache, **{f"data/{k}": v for k, v in data.items()},
                 **{f"init/{k}": v for k, v in init.items()})
    return data, init


def _build_scene(S: dict):
    import jax
    import jax.numpy as jnp

    from fusionsense_tpu.data.synthetic import (
        ring_cameras, sphere_depth_normals, sphere_points,
    )
    from fusionsense_tpu.gaussians.init import init_from_points
    from fusionsense_tpu.gaussians.store import activated
    from fusionsense_tpu.render.rasterize import rasterize

    cams = jax_cameras(S)
    rc = jax_rcfg(S)
    pts, rgb, nrm = sphere_points(n=S["n_gt"], radius=0.5)
    gt = init_from_points(pts, rgb, capacity=S["capacity"], sh_degree=3,
                          seed_normals=nrm, init_opacity=0.95)
    m, q, s, o, c = activated(gt)

    def render(budget):
        rcb = dataclasses.replace(rc, tile_capacity=budget)
        return jax.jit(lambda i: (lambda out: (out.rgb, out.overflow))(
            rasterize(m, q, s, o, c, cams.index(i), rcb)))

    depth_normals = jax.jit(lambda i: sphere_depth_normals(cams.index(i))[:2])
    images, depths, normals = [], [], []
    budget, fn = 2048, render(2048)
    for i in range(S["n_views"]):
        rgb_i, overflow = fn(i)
        while int(overflow) > 0 and budget < 16384:
            budget *= 2
            fn = render(budget)
            rgb_i, overflow = fn(i)
        images.append(np.asarray(rgb_i))
        d, n = depth_normals(i)
        depths.append(np.asarray(d))
        normals.append(np.asarray(n))
    data = {"images": np.stack(images), "sensor_depths": np.stack(depths),
            "normals": np.stack(normals)}
    pts2, rgb2, n2 = sphere_points(n=S["n_init"], radius=0.5, seed=1)
    rng = np.random.RandomState(0)
    pts2 = jnp.asarray(np.asarray(pts2)
                       + 0.02 * rng.randn(*pts2.shape).astype(np.float32))
    init = init_from_points(pts2, jnp.full_like(rgb2, 0.5),
                            capacity=S["capacity"], sh_degree=3,
                            seed_normals=n2)
    return data, {k: np.asarray(v) for k, v in dict(init).items()}


def _focal(S):
    return 550.0 * S["width"] / 640


def jax_cameras(S):
    from fusionsense_tpu.data.synthetic import ring_cameras

    return ring_cameras(n_views=S["n_views"], width=S["width"],
                        height_px=S["height"], focal=_focal(S))


def torch_cameras(S, device="cpu"):
    from fusionsense_tpu_torch.data.synthetic import ring_cameras

    return ring_cameras(n_views=S["n_views"], width=S["width"],
                        height_px=S["height"], focal=_focal(S), device=device)


def _rc_kw(S):
    return dict(tile_size=S["tile"], tile_capacity=S["tile_capacity"],
                max_tiles_per_gaussian=9, tile_chunk=100, sh_degree=3,
                backend="flat")


def jax_rcfg(S):
    from fusionsense_tpu.render.rasterize import RasterizeConfig

    return RasterizeConfig(**_rc_kw(S))


def config(pkg: str, S: dict, seed: int = 0, adc: dict | None = None,
           loss: dict | None = None):
    """bench.py's ExperimentConfig at the scene's size, in `pkg`."""
    if pkg == "jax":
        from fusionsense_tpu import config as C
        from fusionsense_tpu.gaussians.adc import ADCConfig
        from fusionsense_tpu.render.rasterize import RasterizeConfig
    else:
        from fusionsense_tpu_torch import config as C
        from fusionsense_tpu_torch.gaussians.adc import ADCConfig
        from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
    return C.ExperimentConfig(
        model=C.ModelConfig(sh_degree=3,
                            rasterize=RasterizeConfig(**_rc_kw(S)),
                            capacity=S["capacity"], binary_opacities=False),
        train=C.TrainConfig(iterations=15_000, scan_chunk=S["scan_chunk"],
                            log_every=S["log_every"],
                            bin_refresh_steps=S["bin_refresh"],
                            adc=ADCConfig(**(adc or {})), seed=seed),
        loss=C.LossConfig(**(loss or {})))


# ------------------------------------------------------ refine diagnostics --

def refine_diag(step, cfg, scene_scale, opacity, logit, max_scale, avg_grad,
                count, max_radius, alive, frozen) -> dict:
    """What the refine at `step` decides, by cause, from the statistics the
    package computed itself (float32): culls by opacity, world scale and
    screen size (each counted on its own; `culled` is their union), splits
    and dups; `near_hist`, the active opacities in NEAR_BINS bins across
    cull_alpha_thresh +- NEAR_BAND; `near_round`, the active logits within
    NEAR_LOGIT of the threshold's logit (a float32 rounding apart); and
    `near_grad`, the seen average gradients within 1e-5 of
    densify_grad_thresh, relatively. Keys starting with "_" hold the
    per-slot arrays for flip_report and are not written out."""
    f32 = np.float32
    step = int(step)
    active = alive & ~frozen
    can_split = step < cfg.stop_split_at
    screen = step < cfg.stop_screen_size_at
    past_reset = step > cfg.warmup + cfg.reset_alpha_every * cfg.refine_every
    seen = count > 0
    high = (active & seen & can_split
            & (avg_grad > f32(cfg.densify_grad_thresh)))
    big_world = max_scale > f32(cfg.densify_size_thresh * scene_scale)
    big_screen = max_radius > f32(cfg.split_screen_size)
    split = high & (big_world | (screen & big_screen))
    dup = high & ~split
    c_op = active & (opacity < f32(cfg.cull_alpha_thresh))
    c_world = active & past_reset & (max_scale > f32(cfg.cull_scale_thresh
                                                     * scene_scale))
    c_screen = active & past_reset & screen & (max_radius
                                               > f32(cfg.cull_screen_size))
    thr = cfg.cull_alpha_thresh
    edges = np.linspace(thr - NEAR_BAND, thr + NEAR_BAND, NEAR_BINS + 1)
    hist, _ = np.histogram(opacity[active].astype(np.float64), bins=edges)
    t_logit = math.log(thr / (1 - thr))
    g = cfg.densify_grad_thresh
    return {
        "_opacity": opacity, "_culled": c_op | c_world | c_screen,
        "_active": active,
        "refine_step": step, "active": int(active.sum()),
        "cull_opacity": int(c_op.sum()), "cull_world": int(c_world.sum()),
        "cull_screen": int(c_screen.sum()),
        "culled": int((c_op | c_world | c_screen).sum()),
        "split": int(split.sum()), "dupped": int(dup.sum()),
        "near_hist": hist.tolist(),
        "near_round": int((active & (np.abs(logit.astype(np.float64) - t_logit)
                                     <= NEAR_LOGIT)).sum()),
        "near_grad": int((active & seen & (np.abs(avg_grad.astype(np.float64)
                                                  - g) <= 1e-5 * g)).sum()),
    }


# ------------------------------------------------------------- the sides ---

POLICY_INPUTS = (("_maybe_bump_tile_capacity", "tile_overflow"),
                 ("_maybe_resize_pair_budget", "pairs_used"),
                 ("_maybe_adjust_cover_window", "trunc_by_win"))


class Side:
    """One package's trainer on the scene, with spies on what its policies
    read and on its refines. `path` is "run" or "fused"."""

    pkg = ""

    def __init__(self, tr, path: str, S: dict):
        self.tr, self.path, self.S = tr, path, S
        self.inputs: dict = {}
        self.refines: list = []
        for name, key in POLICY_INPUTS:
            fn = getattr(tr, name)

            def spy(x, fn=fn, key=key):
                self.inputs[key] = ([int(v) for v in np.asarray(x).ravel()]
                                    if key == "trunc_by_win" else int(x))
                return fn(x)
            setattr(tr, name, spy)

    def advance(self, to: int):
        tr = self.tr
        if self.path == "run":
            tr.run(iterations=to, log=None)
            return
        ivl = tr.cfg.train.adc.refine_every
        while tr.step < to:
            tr.sync_policies(tr.run_fused(max(1, (to - tr.step) // ivl)))

    def row(self, since: int) -> dict:
        tr = self.tr
        h = tr.history[-1]
        assert h["step"] == tr.step, (h["step"], tr.step)
        psnrs = self.view_psnrs()
        p, alive = self.params()
        lo = p["logit_opacities"][alive].astype(np.float64)
        return {
            "step": tr.step, "num_gaussians": int(h["num_gaussians"]),
            "capacity": tr.gaussians.capacity, "render_n": tr.render_n,
            "tile_capacity": tr.tile_capacity, "cover_tiles": tr.cover_tiles,
            **self.inputs, "loss": float(h["loss"]), "psnr": float(h["psnr"]),
            "psnr_views": float(np.mean(psnrs)),
            "psnr_view": [float(v) for v in psnrs],
            "nonfinite_steps": int(h["nonfinite_steps"]),
            "mean_logit": float(lo.mean()),
            "mean_opacity": float((1 / (1 + np.exp(-lo))).mean()),
            "max_opacity": float((1 / (1 + np.exp(-lo))).max()),
            "refines": [{k: v for k, v in r.items() if k[0] != "_"}
                        for r in self.refines if r["refine_step"] > since],
        }


class JaxSide(Side):
    pkg = "jax"

    def __init__(self, S, data, init, path, seed=0, adc=None, loss=None):
        import jax.numpy as jnp

        from fusionsense_tpu.eval.evaluator import make_render_fn
        from fusionsense_tpu.eval.metrics import psnr
        from fusionsense_tpu.gaussians.store import GaussianState
        from fusionsense_tpu.train import trainer as TRJ

        cfg = config("jax", S, seed, adc, loss)
        cams = jax_cameras(S)
        self.images = jnp.asarray(data["images"])
        tr = TRJ.Trainer(cfg, cams, TRJ.TrainData(
            **{k: jnp.asarray(v) for k, v in data.items()}),
            GaussianState(**{k: jnp.asarray(v) for k, v in init.items()}))
        super().__init__(tr, path, S)
        self._render = make_render_fn(cfg.model.rasterize, cams)
        self._psnr = psnr

    def view_psnrs(self):
        return [float(self._psnr(self._render(self.tr.gaussians,
                                              np.int32(i)).rgb,
                                 self.images[i]))
                for i in range(self.S["n_views"])]

    def params(self):
        g = self.tr.gaussians
        return ({k: np.asarray(v) for k, v in g.params().items()},
                np.asarray(g.alive))


class TorchSide(Side):
    pkg = "torch"

    def __init__(self, S, data, init, path, seed=0, adc=None, loss=None,
                 device="cpu"):
        from fusionsense_tpu_torch import convert
        from fusionsense_tpu_torch.train import trainer as TRT

        cfg = config("torch", S, seed, adc, loss)
        cams = torch_cameras(S, device)
        td = convert.train_data_from_numpy(data, device)
        self.images = td.images
        tr = TRT.Trainer(cfg, cams, td, convert.state_from_numpy(init, device),
                         device=device)
        super().__init__(tr, path, S)

    def view_psnrs(self):
        from fusionsense_tpu_torch.eval.evaluator import view_psnrs

        return view_psnrs(self.tr.gaussians, self.tr.camera, self.images,
                          self.tr.cfg.model.rasterize)

    def params(self):
        g = self.tr.gaussians
        return ({k: v.detach().cpu().numpy() for k, v in g.params().items()},
                g.alive.cpu().numpy())


# -------------------------------------------------------------- the spies --

class Spies:
    """Patches, undone by restore(): each package's refine records
    refine_diag into the sides' lists (JAX's through a debug callback, so
    the fused program's on-device refines report too), and in lockstep the
    port's split normals and SDF samples are JAX's draws for the same
    seeds."""

    def __init__(self):
        self._undo = []
        self.jax_sink: list = [[]]

    def _set(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo = []

    def jax_refine(self):
        """JAX's refines record into jax_sink[0], the list of the side that
        is advancing (the JAX trainers of a control run share the module's
        refine)."""
        import jax
        import jax.numpy as jnp

        from fusionsense_tpu.train import trainer as TRJ

        orig = TRJ.refine
        sink = self.jax_sink

        def refine(state, opt, stats, key, cfg, step, scene_scale=1.0):
            def record(*a):
                sink[0].append(refine_diag(a[0], cfg, scene_scale, *a[1:]))
            jax.debug.callback(
                record, step, jax.nn.sigmoid(state.logit_opacities),
                state.logit_opacities,
                jnp.max(jnp.exp(state.log_scales), axis=-1),
                stats.grad2d_acc / jnp.maximum(stats.count, 1), stats.count,
                stats.max_radius, state.alive, state.frozen)
            return orig(state, opt, stats, key, cfg, step,
                        scene_scale=scene_scale)
        self._set(TRJ, "refine", refine)

    def torch_refine(self, sink: list):
        import torch

        from fusionsense_tpu_torch.train import trainer as TRT

        orig = TRT.refine

        def refine(state, opt, stats, noise, cfg, step, scene_scale=1.0):
            a = [torch.sigmoid(state.logit_opacities), state.logit_opacities,
                 torch.amax(torch.exp(state.log_scales), dim=-1),
                 stats.grad2d_acc / torch.clamp_min(stats.count, 1),
                 stats.count, stats.max_radius, state.alive, state.frozen]
            sink.append(refine_diag(step, cfg, scene_scale,
                                    *[t.detach().cpu().numpy() for t in a]))
            return orig(state, opt, stats, noise, cfg, step,
                        scene_scale=scene_scale)
        self._set(TRT, "refine", refine)

    def jax_draws(self):
        """The port's split normals and SDF samples from JAX's PRNG keys:
        the generator's seed is the JAX trainer's per-step seed."""
        import jax
        import jax.numpy as jnp
        import torch

        from fusionsense_tpu.train import sdf_loss as SDJ
        from fusionsense_tpu_torch.train import trainer as TRT

        def split_noise(generator, n, capacity, device=None):
            key = jax.random.PRNGKey(np.uint32(generator.initial_seed()))
            keys = jax.random.split(key, max(n, 2))
            return torch.tensor(np.stack([np.asarray(jax.random.normal(
                k, (capacity, 3))) for k in keys]), device=device)

        def sdf_samples(generator, means, quats, scales, alive, n_samples):
            host = [jnp.asarray(t.detach().cpu().numpy())
                    for t in (means, quats, scales, alive)]
            pts, idx = SDJ.sample_points_in_gaussians(
                jax.random.PRNGKey(np.uint32(generator.initial_seed())),
                *host, n_samples)
            return (torch.tensor(np.asarray(pts), device=means.device),
                    torch.tensor(np.asarray(idx), dtype=torch.int64,
                                 device=means.device))
        self._set(TRT, "split_noise", split_noise)
        self._set(TRT, "sample_points_in_gaussians", sdf_samples)


def perturbed(init: dict, rel: float = 1e-7) -> dict:
    """The initial state with every float parameter moved by rel x a
    standard normal of itself (RandomState(1)): about one float32 rounding,
    the control against which the port's lockstep drift is read."""
    rng = np.random.RandomState(1)
    return {k: (v * (1 + rel * rng.standard_normal(v.shape))).astype(v.dtype)
            if v.dtype == np.float32 else v for k, v in init.items()}


def agreement(a: Side, b: Side) -> tuple[float, int]:
    """(share, n): of the n slots alive in both states, the share whose
    parameters all agree to AGREE_ATOL + AGREE_RTOL |b|."""
    pa, alive_a = a.params()
    pb, alive_b = b.params()
    n = min(alive_a.shape[0], alive_b.shape[0])
    both = alive_a[:n] & alive_b[:n]
    ok = np.ones(n, bool)
    for k, x in pa.items():
        y = pb[k][:n]
        close = np.abs(x[:n] - y) <= AGREE_ATOL + AGREE_RTOL * np.abs(y)
        ok &= close.reshape(n, -1).all(axis=1)
    nb = int(both.sum())
    return (float((ok & both).sum()) / max(nb, 1), nb)


# --------------------------------------------------------------- the runs --

def run(mode: str, path: str, S: dict, steps: int, seed: int = 0,
        packages=("jax", "torch"), adc: dict | None = None,
        loss: dict | None = None, scene=None, emit=None) -> list[dict]:
    """Train the named packages from one numpy start to `steps`, a row per
    package (and, in lockstep, their agreement) at every S["every"] steps.
    Returns the rows; `emit` is called with each as it is made."""
    if mode == "lockstep":
        packages = ("jax", "torch")
    if mode == "control":
        packages = ("jax", "jax_perturbed")
    data, init = scene if scene is not None else scene_numpy(S)
    spies = Spies()
    sides = []
    try:
        for pkg in packages:
            side_cls = TorchSide if pkg == "torch" else JaxSide
            start = perturbed(init) if pkg == "jax_perturbed" else init
            side = side_cls(S, data, start, path, seed=seed, adc=adc,
                            loss=loss)
            side.pkg = pkg
            sides.append(side)
        if any(sd.pkg != "torch" for sd in sides):
            spies.jax_refine()
        if "torch" in packages:
            spies.torch_refine(sides[-1].refines)
        if mode == "lockstep":
            spies.jax_draws()
        rows = []
        prev = 0
        aligned = True
        for b in range(S["every"], steps + 1, S["every"]):
            row = {"mode": mode, "path": path, "seed": seed,
                   "width": S["width"], "step": b}
            for side in sides:
                t0 = time.perf_counter()
                spies.jax_sink[:] = [side.refines]
                side.advance(b)
                row[side.pkg] = side.row(prev)
                row[side.pkg]["seconds"] = time.perf_counter() - t0
            if len(sides) == 2:
                row["agree"], row["alive_both"] = agreement(sides[1], sides[0])
                # slot by slot while the two states keep one slot order
                pairs = zip(*[[r for r in sd.refines
                               if r["refine_step"] > prev] for sd in sides])
                row["refine_flips"] = [
                    {"refine_step": a["refine_step"], **flip_report(a, b)}
                    for a, b in pairs if aligned]
                aligned &= all(row[sides[0].pkg][k] == row[sides[1].pkg][k]
                               for k in ("num_gaussians", "capacity"))
                for sd in sides:     # the per-slot arrays are spent
                    sd.refines[:] = [{k: v for k, v in r.items()
                                      if k[0] != "_"} for r in sd.refines]
            rows.append(row)
            prev = b
            if emit:
                emit(row)
        return rows
    finally:
        spies.restore()


def flip_report(rj: dict, rt: dict, limit: int = 8) -> dict:
    """The refine's decisions slot by slot, for two states in the same slot
    order (lockstep before the populations first differ): the slots culled
    in one package and not the other with their opacities in both, the
    largest |d opacity| over slots active in both, and the slots whose
    opacities differ by more than 1e-3."""
    both = rj["_active"] & rt["_active"]
    d = np.abs(rj["_opacity"].astype(np.float64) - rt["_opacity"])
    flip = both & (rj["_culled"] != rt["_culled"])
    idx = np.flatnonzero(flip)
    return {
        "flips": int(flip.sum()),
        "flipped": [{"slot": int(i), "jax_opacity": float(rj["_opacity"][i]),
                     "torch_opacity": float(rt["_opacity"][i]),
                     "jax_culled": bool(rj["_culled"][i])}
                    for i in idx[:limit]],
        "d_opacity_max": float(d[both].max()) if both.any() else 0.0,
        "d_opacity_over_1e3": int((both & (d > 1e-3)).sum()),
    }


def _pair(row):
    """The two sides' keys of a lockstep or control row."""
    return [k for k in ("jax", "torch", "jax_perturbed") if k in row]


def first_divergence(rows, keys=("num_gaussians", "capacity", "render_n",
                                 "tile_capacity", "cover_tiles")):
    """The first lockstep (or control) row whose two sides differ in any of
    `keys`, or None."""
    for r in rows:
        a, b = (r[k] for k in _pair(r))
        if any(a[k] != b[k] for k in keys):
            return r
    return None


def lockstep_report(rows) -> list[str]:
    """One line per boundary of a lockstep run: the populations and their
    gap beside each refine's near-threshold opacity counts (within
    NEAR_BAND, and within a float32 rounding), the policy state when it
    differs, the 9-view PSNR of both, the parameter agreement, and the
    slot-by-slot flips while the slot orders agree; then the first
    divergence."""
    keys = ("capacity", "render_n", "tile_capacity", "cover_tiles")
    out = []
    for r in rows:
        j, t = (r[k] for k in _pair(r))
        gap = t["num_gaussians"] - j["num_gaussians"]
        line = (f"{r['step']}: alive {j['num_gaussians']} / "
                f"{t['num_gaussians']} (gap {gap:+d}); "
                f"9-view PSNR {j['psnr_views']:.4f} / {t['psnr_views']:.4f}; "
                f"agree {r['agree']:.4f}")
        diff = {k: (j[k], t[k]) for k in keys if j[k] != t[k]}
        if diff:
            line += f"; policies differ {diff}"
        for a, b in zip(j["refines"], t["refines"]):
            line += (f"; refine {a['refine_step']}: culled {a['culled']} / "
                     f"{b['culled']} (opacity {a['cull_opacity']} / "
                     f"{b['cull_opacity']}, world {a['cull_world']} / "
                     f"{b['cull_world']}, screen {a['cull_screen']} / "
                     f"{b['cull_screen']}), split {a['split']} / "
                     f"{b['split']}, dupped {a['dupped']} / {b['dupped']}, "
                     f"near +-{NEAR_BAND:g} {sum(a['near_hist'])} / "
                     f"{sum(b['near_hist'])}, near 1e-6 logit "
                     f"{a['near_round']} / {b['near_round']}")
        for f in r.get("refine_flips", []):
            line += (f"; flips {f['flips']} (max |d opacity| "
                     f"{f['d_opacity_max']:.3g}, over 1e-3: "
                     f"{f['d_opacity_over_1e3']}) {f['flipped']}")
        out.append(line)
    first = first_divergence(rows)
    out.append("first divergence: " + ("none" if first is None
                                       else f"step {first['step']}"))
    # the summary PERF.md quotes: at each refine, the population gap after
    # it beside both near-threshold counts (+-NEAR_BAND; and within a
    # float32 rounding, summed over the run)
    brief, rounding = [], 0
    for r in rows:
        j, t = (r[k] for k in _pair(r))
        for a, b in zip(j["refines"], t["refines"]):
            gap = t["num_gaussians"] - j["num_gaussians"]
            brief.append(f"{a['refine_step']} {gap:+d} "
                         f"({sum(a['near_hist'])}/{sum(b['near_hist'])})")
            rounding += a["near_round"] + b["near_round"]
    out.append("refine gap (near +-%g): " % NEAR_BAND + ", ".join(brief))
    out.append(f"within a float32 rounding of the threshold, over all "
               f"refines of both: {rounding}")
    return out


# ------------------------------------------------------------- envelope ---

def read_rows(paths) -> list[dict]:
    rows = []
    for p in paths:
        with open(p) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    return rows


def trajectories(rows, pkg: str) -> dict:
    """{seed: {step: row of pkg}} from free-mode rows."""
    out: dict = {}
    for r in rows:
        if pkg in r:
            out.setdefault(r["seed"], {})[r["step"]] = r[pkg]
    return out


TRACKED = ("num_gaussians", "psnr_views", "psnr", "loss", "render_n",
           "tile_capacity", "pairs_used", "capacity")


def envelope_json(rows, command: str, path: str = "fused") -> dict:
    """The committed reference: the JAX seeds' trajectories (numbers only)
    at each boundary."""
    tr = trajectories(rows, "jax")
    seeds = sorted(tr)
    steps = sorted(set.intersection(*[set(t) for t in tr.values()]))
    return {
        "command": command, "path": path, "scene": SCENE_DOC,
        "criterion": CRITERION_DOC, "seeds": seeds,
        "boundaries": [{"step": s, **{k: [tr[sd][s][k] for sd in seeds]
                                      for k in TRACKED}} for s in steps],
    }


CRITERION_DOC = ("at each boundary, the other runs' seed-mean of "
                 "num_gaussians and of psnr_views within the JAX seeds' mean "
                 "+- max(2 x their sample standard deviation (ddof 1), "
                 "2% of alive / 0.1 dB)")
SCENE_DOC = ("bench.py's scene at 160x120: 9 ring views, focal 137.5, 6,000 "
             "GT / 3,000 init points, tile 16, capacity 2^14, ADCConfig(), "
             "LossConfig(), bin_refresh_steps 18, flat, float32 on the CPU")


def envelope(ref: dict) -> dict:
    """{step: {"num_gaussians": (lo, hi), "psnr_views": (lo, hi)}} from the
    committed reference (read as data)."""
    out = {}
    for b in ref["boundaries"]:
        e = {}
        for k, floor in (("num_gaussians", None), ("psnr_views", PSNR_FLOOR)):
            v = np.asarray(b[k], np.float64)
            mean = float(v.mean())
            sd = float(v.std(ddof=1)) if v.size > 1 else 0.0
            half = max(2 * sd, ALIVE_FLOOR * mean if floor is None else floor)
            e[k] = (mean - half, mean + half)
        out[b["step"]] = e
    return out


def check_envelope(ref: dict, seed_runs: dict) -> list[dict]:
    """seed_runs: {seed: {step: {"num_gaussians", "psnr_views"}}}. One entry
    per reference boundary: the seed-means, the bounds, and `ok`."""
    env = envelope(ref)
    out = []
    for step, e in sorted(env.items()):
        have = [r[step] for r in seed_runs.values() if step in r]
        if not have:
            continue
        entry = {"step": step, "seeds": len(have), "ok": True}
        for k, (lo, hi) in e.items():
            m = float(np.mean([h[k] for h in have]))
            entry[k] = m
            entry[k + "_bounds"] = (lo, hi)
            entry["ok"] &= lo <= m <= hi
        out.append(entry)
    return out


# ------------------------------------------------------------------ main ---

def _one_thread():
    """One core per run, so several runs go side by side: torch's intra-op
    threads and XLA's Eigen pool (set before JAX makes its CPU client)."""
    import torch

    torch.set_num_threads(1)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false"
                               " intra_op_parallelism_threads=1").strip()


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      str(REPO / "build" / "jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("lockstep", "control", "free",
                                     "envelope", "check", "report"))
    ap.add_argument("inputs", nargs="*",
                    help="row files (envelope, check, report)")
    ap.add_argument("--path", choices=("run", "fused"), default="fused")
    ap.add_argument("--package", choices=("jax", "torch"), default="torch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, choices=sorted(SIZES), default=160)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--every", type=int, default=None)
    ap.add_argument("--adc", default="{}", help="ADCConfig fields, as JSON")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reference", default=str(
        REPO / "tests" / "torch_long_parity_jax.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    if args.mode == "envelope":
        ref = envelope_json(read_rows(args.inputs),
                            "python tests/torch_long_parity.py "
                            + " ".join(sys.argv[1:] if argv is None else argv))
        head = {k: v for k, v in ref.items() if k != "boundaries"}
        Path(args.out).write_text(
            json.dumps(head, indent=1)[:-2] + ',\n "boundaries": [\n'
            + ",\n".join(json.dumps(b) for b in ref["boundaries"])
            + "\n ]\n}\n")
        return 0
    if args.mode == "report":
        print("\n".join(lockstep_report(read_rows(args.inputs))))
        return 0
    if args.mode == "check":
        ref = json.loads(Path(args.reference).read_text())
        runs = trajectories(read_rows(args.inputs), "torch")
        ok = True
        for e in check_envelope(ref, runs):
            print(json.dumps(e))
            ok &= e["ok"]
        print("inside the envelope" if ok else "OUTSIDE the envelope")
        return 0 if ok else 1

    _one_thread()
    _jax_cpu()
    over = {k: v for k, v in (("capacity", args.capacity),
                               ("every", args.every),
                               ("log_every", args.every),
                               ("scan_chunk", args.every)) if v}
    S = scene_spec(args.size, **over)
    scene = scene_numpy(S, str(REPO / "build" / "long_parity"
                               / f"scene_{args.size}_{S['capacity']}.npz"))
    out = open(args.out, "w") if args.out else sys.stdout
    t0 = time.time()

    def emit(row):
        out.write(json.dumps(row) + "\n")
        out.flush()
        sides = [row[p] for p in _pair(row)]
        print(f"[{time.time() - t0:.0f}s] step {row['step']}: "
              + "; ".join(f"n {s['num_gaussians']} psnr_views "
                          f"{s['psnr_views']:.3f}" for s in sides)
              + (f"; agree {row['agree']:.4f}" if "agree" in row else ""),
              file=sys.stderr, flush=True)

    packages = (args.package,) if args.mode == "free" else None
    run(args.mode, args.path, S, args.steps, seed=args.seed,
        packages=packages, adc=json.loads(args.adc), scene=scene, emit=emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
