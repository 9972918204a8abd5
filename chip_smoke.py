"""Drive the PyTorch/H100 port's main paths on one card and hold each of
its CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py             # from the root of a checkout, one card

Phases (any failure exits non-zero and prints no result):
 1. device and build: the card's name, power limit and SM clock; whether
    Pillow, scipy, scikit-learn and imageio import (the port's path needs
    Pillow and scipy); the nvcc build of every kernel (one process per source, all at
    once) with its ptxas register / shared-memory report;
 2. the bench scene (bench.py's workload, built with the port's own code):
    9 views at 640x480, 60,000 GT points rendered through K1, a 30,000-point
    perturbed initial state at capacity 131,072, the flat backend at tile 32;
 3. K1/K2 against plain versions on view 0's real table at the trainer's
    initial pair budget and cover window, then each of their five stages
    against its plain twin on the same inputs (fwd_blocks' count of the
    rows it staged against the plain cull's); the longest run, the rows
    culled (dead slots among them) and the smallest skip-decision margin;
 4. the flat path: Trainer.run for 60 steps (the bin cache is refreshed and
    reused), with every launch counter zeroed just before and read after;
    the last 50 steps, one chunk at one shape, are timed;
 5. K1/K2 and their stages against plain versions again, on the trained
    state at the shape those 50 steps ran, each timed with CUDA events
    (K1/K2 beside their bounds); the two block passes timed again with the
    cull defeated (the culled rows' log_op raised just above its bound, so
    their alpha stays 0 and the outputs must not move); then K1/K2's
    blend_bf16 branch (ROADMAP N5) and its stages against their plain twins
    on the same inputs (check_bf16: the float32 limits on all but a small
    share of elements, and the float32 kernel several times farther off),
    and timed;
 6. a torch.profiler trace of 5 more flat steps: device time by kernel and
    the device's busy share of the step;
 7. the dense path on the same scene and initial state: the dn_splatter
    preset's model and loss with backend="pallas" (tile 16, K 512, cover up
    to 16 tiles, binary opacities), no bin cache. K3/K4 against plain
    versions on view 0's real (T, K) table, then each of their four stages
    against its plain twin on the same inputs, and the forward chunks the
    stop rule discards; Trainer.run for 60 steps with the counters zeroed
    just before and read after, the last 50 timed; K3/K4 and their stages
    checked again and timed at the timed steps' shape, their blend_bf16
    branch too; a profile of 5 more dense steps;
 8. the fusionsense path on the same scene and initial state: the
    fusionsense preset with backend="pallas" through its whole schedule,
    scaled as the JAX package's full-schedule CPU test scales it (depth cut:
    ADCConfig(warmup=100, refine_every=50, reset_alpha_every=4,
    stop_split_at=600), touch anchoring at step 150, binary-opacity margin
    60, 700 steps instead of 15,000): 10 ADC refines with their counts, the
    population, capacity, render prefix, K, cover and the boundary's time;
    4 synthetic touch patches of 400 points anchored by a callback
    (gel_scale 0.01) and touch_prune at every later boundary; the opacity
    resets at steps 300 and 500 (largest live opacity after each <= 0.201);
    frozen-alive count 1,600 after the anchoring and at the end; PSNR
    rising; ms/step and peak memory; the launch counters zeroed just before
    and read just after. Then K3/K4 (and their stages) against their plain
    versions at the post-refine shape, timed; a checkpoint saved and
    restored into a fresh Trainer, both run 10 more steps (losses within
    1e-5 relative); the splat PLY written and read back (count =
    num_alive); 20 more steps with camera optimisation and the SDF loss
    (finite loss each step, nonzero pose deltas);
 9. the mesh phase: mesh_export.extract with each of its five methods
    (tsdf, dn, sugar-coarse, gaussians, marching) at their defaults
    (resolution MESH_RES = 192) on the fusionsense path's
    trained model, each timed with CUDA synchronisation and the launch
    counters zeroed just before and read just after: the methods that
    render launch K3 at least once per view, its plain twin never; then
    tsdf on the flat path's model, which launches K1. Seconds, verts and
    faces per method; the tsdf meshes' chamfer x 1e3 against N_SPHERE
    points of the GT sphere;
10. fs-train's default backend, jax (the plain PyTorch compositor), on the
    same scene and initial state: the dn_splatter preset for 60 steps,
    ms/step, peak memory, view-0 PSNR rising, no kernel launched;
11. fs-train end to end from a capture on disk: the port's blob capture
    written on the card at 640x480 (focal 550) with a touch patch, its seed
    cloud dropped from transforms.json so the visual hull and the seed
    cloud from depth both run; cli.train.main with --backend pallas for
    600 steps (warmup 100, stop-split 600, so the high-grad export fires at
    step 100; touch at 150, checkpoints every 300, the CLI's default --mesh
    tsdf sugar-coarse), then a second main resumed from ckpt_300 to step
    360 (an empty --mesh). Seconds per stage (the mesh stage's too), the
    prior and seed counts, ms/step, peak memory, the K3/K4 launches (their
    plain twins never), the metrics.json means and the logged PSNR, which
    must rise; every artifact read back through the port's own readers; the
    resumed run must enter at step 300 with the patch frozen, and its
    high-grad export (from the settled population) must find points whose
    clusters and ranks read back; then K3/K4 against their plain versions
    on the first run's trained state, and timed there; then fs-mesh (tsdf)
    and fs-eval on the first run's last checkpoint, through K3;
12. fused refine intervals (Trainer.run_fused, CUDA graph replays of the
    step) on the bench scene, for the flat configuration and for the dense
    one (dn_splatter, pallas): refines every 50 steps from step 100 and the
    adaptive policies held still; eager Trainer.run to step 200, then from
    a copy of that trainer (a) Trainer.run and (b) run_fused(4, 50) +
    sync_policies to step 400: n_alive and the alive masks equal, means
    within rtol 1e-4 / atol 1e-5, last PSNR within 0.05; the graphs, their
    capture seconds and pool; K1/K2 (K3/K4) launched once per step inside
    the replays, their plain twins never; one more interval with
    torch.cuda.set_sync_debug_mode("error") (no host sync, refine
    included); ms/step over two timed windows beside the eager step; a
    profiled interval: device kernels, host launch calls and busy share
    per step;
13. the monocular priors on phase 11's capture (a copy): DSINE
    (EfficientNet-B5), Metric3D (ViT-S, 4 registers) and Depth-Anything
    (ViT-S) at their default widths, each from a seeded random state dict
    written as its published file is wrapped and loaded back through the
    port's load_*_checkpoint; generate_priors with Metric3D depth and DSINE
    normals over every frame, the artifacts read back (depth finite in
    Metric3D's [0, 300] m clamp, normals unit within 1e-3, transforms.json
    patched); Depth-Anything's depth aligned onto the sensor depth
    (align_mono_depths: finite, closer to the sensor than before); for view
    0 of each net the card against the same net and weights on the CPU
    (max |d| and the share of pixels past PRIOR_NORMAL_ATOL /
    PRIOR_DEPTH_RTOL; at most PRIOR_FRAC), and again with TF32 allowed
    (reported only); ms per frame and peak memory;
14. fs-render on phase 11's last checkpoint (a copy with pose deltas):
    dataset (train split, the deltas applied) with --backend pallas,
    interpolate with jax, spiral with flat, camera-path (a camera_path.json
    through three capture poses) with pallas; each mode's K1/K3 launches
    counted (nonzero where its backend has a kernel, no other kernel and
    no plain twin), every PNG read back at 640x480; the dataset renders
    masked by the capture's masks (eval.mask_render.mask_images);
15. a {"kernels": [...]} line for all four kernels (K3/K4 timed at the
    fusionsense path's post-refine shape; launches those of every path
    that runs the kernel, graph replays, the mesh renders and fs-render's
    renders included; errors the largest of every check; the blend_bf16
    branch's times and error beside the float32 ones), the card line, and
    last the result line.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT, N_VIEWS, FOCAL = 640, 480, 9, 550.0
N_GT, N_INIT, CAPACITY = 60_000, 30_000, 1 << 17
WARM_STEPS, TRAIN_STEPS = 10, 60
TIMED_LAUNCHES, WARM_LAUNCHES = 50, 5
# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (live pair, pixel), transcendentals counted as one:
# forward: alpha 20 (2 subs, 9 for the conic quadratic, 2 for log_op and
# sign, min, exp, 2 compares/selects, 2 more for the tests) + log1p, prefix
# add, 2 adds, exp, mul + 8 FMAs into the channels (16) = 43;
# backward: alpha 20 + log1p, sub, exp, log-T update, w (5) + q = 8 FMAs (16)
# + a and the suffix (2) + 1/(1-alpha) (2) + d_alpha (6) + d_power (2)
# + gx, gy (6) + 6 geometric terms (8) + 8 d_chan products + 14 sums = 89.
FWD_OPS, BWD_OPS = 43, 89
TOL_OUT, TOL_ALPHA = 1e-5, 1e-6
# dtab is held column by column at the column's own scale: max|d| of a
# column <= TOL_DTAB_REL * max|dtab_plain| of that column
TOL_DTAB_REL = 1e-5
G_SCALE = 1e-4    # cotangent scale for K2's check: ~30x the per-pixel
#                   cotangent of a mean loss over 640x480
# the blend_bf16 branches (N5) against their plain twins, at the float32
# limits above. Both round w after forming it as alpha * T_excl, but from
# alpha (FMA-contracted in the kernel) and prefix sums (serial there, a
# cumsum in the twin) whose last bits differ, so a w near a rounding
# boundary lands on the neighbouring bf16 value in one of them. So each
# product a bf16 stage writes is held to the float32 limit on all but
# BF16_FLIP_FRAC of its elements, and those within one bf16 ulp (2^-8) of
# a unit channel (out, acc) or of the scale (S, dtab columns). And the
# float32 kernel on the same inputs must lie at least BF16_SEEN times
# farther from the bf16 twin than the bf16 kernel does, in mean |d| (in
# every column of dtab): a kernel that ignored the flag fails there.
# Set from the readings of PERF.md section 6 (H100): at most 1.3e-4 of the
# elements past the float32 limit, max|d| 2.5e-3, the float32 kernel at
# least 1,050 times farther off.
BF16_ULP, BF16_FLIP_FRAC, BF16_SEEN = 4e-3, 1e-3, 100.0
# the fusionsense path: the preset's schedule with the depth cut of the JAX
# package's full-schedule CPU test (tests/test_quality_ledger.py:201-207)
FS_STEPS, FS_CHUNK = 700, 50
FS_ADC = dict(warmup=100, refine_every=50, reset_alpha_every=4,
              stop_split_at=600)
FS_TOUCH_AT, FS_MARGIN = 150, 60
FS_PATCHES, FS_PATCH_PTS, FS_GEL = 4, 400, 0.01
RESET_CEIL = 0.201         # 2 * cull_alpha_thresh, and float slack
RESUME_STEPS, CAM_STEPS = 10, 20
TOL_RESUME = 1e-5          # relative, loss of the resumed run
SCRATCH = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the pipeline phase: fs-train in the port on the blob capture written at
# the bench's width (the fixture's focal 110 at 128x96, scaled x5)
PIPE_ITERS, PIPE_WARMUP, PIPE_STOP_SPLIT = 600, 100, 600
PIPE_TOUCH_AT, PIPE_SAVE, PIPE_RESUME_ITERS = 150, 300, 360
PIPE_METRICS = ("psnr", "masked_psnr", "ssim", "depth_abs_rel", "normal_mae",
                "fps", "num_gaussians")
# the fused phase: refines every 50 from step 100, eager to FUSED_FROM, then
# FUSED_INTERVALS intervals of 50 both ways; windows of 2 and 3 x 2 intervals
FUSED_ADC = dict(warmup=100, refine_every=50)
FUSED_FROM, FUSED_INTERVALS, FUSED_WINDOW = 200, 4, 2
TOL_FUSED = dict(rtol=1e-4, atol=1e-5)   # tests/test_train_e2e.py:289's
TOL_FUSED_PSNR = 0.05
# the mesh phase: mesh_export.extract's default resolution for every
# method (marching's 7.1 M KNN queries included); the chamfer of the tsdf
# meshes against N_SPHERE points of the scene's GT sphere (radius 0.5), as
# full_schedule_torch.py measures it
MESH_RES, N_SPHERE = 192, 20_000
# the priors phase: DSINE, Metric3D and Depth-Anything at their default
# (published) widths with seeded random weights (weights.random_state_dict
# at a deep net's scale), on the pipeline phase's capture. Card against CPU
# on view 0: a pixel is past the limit where its normal moves by more than
# PRIOR_NORMAL_ATOL or its depth (inverse depth) by more than
# PRIOR_DEPTH_RTOL of itself; at most PRIOR_FRAC of the pixels may be.
PRIOR_SEED = 0
PRIOR_NORMAL_ATOL, PRIOR_DEPTH_RTOL, PRIOR_FRAC = 1e-3, 1e-3, 1e-3
PRIOR_UNIT_TOL = 1e-3      # | |n| - 1 | of every stored normal
PRIOR_DEPTH_CLAMP = 300.0  # Metric3D's clamp, metres (wrapper.py)
DA_BIAS_LIFT = 1.0         # Depth-Anything's last bias, so its ReLU passes
# the render phase: frames of the interpolate and spiral modes
RENDER_FRAMES = 8


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, n, warm):
    """Mean device ms of fn over n launches after `warm` warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def build_scene(torch, dev):
    """bench.py's scene and trainer configuration, from the port's code."""
    import numpy as np

    from fusionsense_tpu_torch.config import (
        ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
    )
    from fusionsense_tpu_torch.data.synthetic import (
        ring_cameras, sphere_depth_normals, sphere_points,
    )
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig
    from fusionsense_tpu_torch.gaussians.init import init_from_points
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render.rasterize import (
        RasterizeConfig, rasterize,
    )
    from fusionsense_tpu_torch.train.trainer import TrainData

    rcfg = RasterizeConfig(tile_size=32, tile_capacity=512,
                           max_tiles_per_gaussian=9, tile_chunk=100,
                           sh_degree=3, backend="flat")
    cams = ring_cameras(n_views=N_VIEWS, width=WIDTH, height_px=HEIGHT,
                        focal=FOCAL, device=dev)
    pts, rgb, normals = sphere_points(n=N_GT, radius=0.5, device=dev)
    gt = init_from_points(pts, rgb, capacity=CAPACITY, sh_degree=3,
                          seed_normals=normals, init_opacity=0.95)
    # the GT model's dead slots have opacity 0: render its alive prefix
    m, q, s, o, c = (x[:N_GT] for x in activated(gt))
    imgs, deps, nms = [], [], []
    budget = 2048
    with torch.no_grad():
        for i in range(N_VIEWS):
            while True:   # grow the GT pair budget on overflow, as bench.py
                out = rasterize(m, q, s, o, c, cams.index(i),
                                dataclasses.replace(rcfg, tile_capacity=budget),
                                device=dev)
                if int(out.overflow) == 0 or budget >= 16384:
                    break
                budget *= 2
            if int(out.overflow):
                raise RuntimeError(f"GT view {i} dropped {int(out.overflow)} "
                                   f"pairs at budget {budget}")
            imgs.append(out.rgb)
            d, n, _ = sphere_depth_normals(cams.index(i))
            deps.append(d)
            nms.append(n)
    data = TrainData(images=torch.stack(imgs), sensor_depths=torch.stack(deps),
                     normals=torch.stack(nms))
    pts2, rgb2, n2 = sphere_points(n=N_INIT, radius=0.5, seed=1, device=dev)
    rng = np.random.RandomState(0)
    noise = 0.02 * rng.randn(*pts2.shape).astype(np.float32)
    init = init_from_points(pts2 + torch.as_tensor(noise, device=dev),
                            torch.full_like(rgb2, 0.5), capacity=CAPACITY,
                            sh_degree=3, seed_normals=n2)
    cfg = ExperimentConfig(
        model=ModelConfig(sh_degree=3, rasterize=rcfg, capacity=CAPACITY,
                          binary_opacities=False),
        train=TrainConfig(iterations=15_000, scan_chunk=50,
                          bin_refresh_steps=2 * N_VIEWS, adc=ADCConfig()),
        loss=LossConfig())
    return cams, data, init, cfg, budget


def view_psnr(torch, tr, view):
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render.rasterize import rasterize

    # the alive-first prefix at a fixed generous budget, so the start and
    # end renders compare like with like
    rc = dataclasses.replace(tr.cfg.model.rasterize, tile_capacity=2048)
    with torch.no_grad():
        out = rasterize(*(x[:tr.render_n] for x in activated(tr.gaussians)),
                        tr.camera.index(view), rc, device=tr.device)
        mse = torch.mean((out.rgb - tr.data.images[view]) ** 2)
        return float(-10.0 * torch.log10(mse + 1e-10))


def timed_entries(source, specs):
    """Time each (name, replaces, kernel, plain, bound_ms, bound_by) with
    CUDA events and describe it as an entry of the {"kernels"} line;
    launches and max_abs_err are filled in by the caller."""
    entries = []
    for name, replaces, fn, fn_plain, bound_ms, bound_by in specs:
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": None,
            "ms": cuda_ms(fn, TIMED_LAUNCHES, WARM_LAUNCHES),
            "plain_ms": cuda_ms(fn_plain, TIMED_LAUNCHES, WARM_LAUNCHES),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        log(f"{name}: {entries[-1]['ms']:.4f} ms, plain "
            f"{entries[-1]['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return entries


def time_bf16(entries, fns, errs):
    """The blend_bf16 branch's times (kernel and plain twin, CUDA events as
    for float32) and largest error, into each kernel's entry of the
    {"kernels"} line beside its float32 numbers."""
    for e, (fn, fn_p), err in zip(entries, fns, errs):
        e["bf16_ms"] = cuda_ms(fn, TIMED_LAUNCHES, WARM_LAUNCHES)
        e["bf16_plain_ms"] = cuda_ms(fn_p, TIMED_LAUNCHES, WARM_LAUNCHES)
        e["bf16_max_abs_err"] = err
        log(f"{e['name']} bf16: {e['bf16_ms']:.4f} ms (float32 "
            f"{e['ms']:.4f}), plain {e['bf16_plain_ms']:.3f} ms, bound "
            f"{e['bound_ms']:.4f} ms")


def check_columns(name, dtab, dtab_p, tol=TOL_DTAB_REL):
    """dtab held column by column at the column's own scale (max|d| of a
    column <= tol * max|dtab_plain| of that column); returns the largest
    absolute difference."""
    dtab, dtab_p = dtab.reshape(-1, dtab.shape[-1]), dtab_p.reshape(-1, dtab.shape[-1])
    err_col = (dtab - dtab_p).abs().amax(dim=0)
    scale_col = dtab_p.abs().amax(dim=0)
    nonzero = dtab_p.abs()[dtab_p != 0]
    rel_col = (err_col / scale_col.clamp_min(1e-30)).tolist()
    log(f"{name} max|d| dtab {float(err_col.max()):.3e}; median nonzero "
        f"|dtab_plain| {float(nonzero.median()):.3e}; per column max|d| / "
        f"max|dtab_plain| (limit {tol:.0e}): "
        + " ".join(f"{r:.1e}" for r in rel_col))
    if not bool((err_col <= tol * scale_col).all()):
        raise RuntimeError(f"{name} disagrees with its plain version")
    return float(err_col.max())


def check_bf16(torch, name, got, plain, f32, limit, scale="abs"):
    """A product of the blend_bf16 branch: the bf16 kernel's `got` against
    the bf16 twin's `plain` on the same inputs, beside `f32`, the float32
    kernel's on those inputs. |d| is taken absolutely (`scale` "abs"),
    over max|plain| ("max") or over each column's max|plain| ("columns",
    the last dimension). At most BF16_FLIP_FRAC of the elements may exceed
    the float32 `limit`, none may exceed BF16_ULP, and f32's mean |d| must
    be at least BF16_SEEN times got's (in each column, for "columns").
    Returns the largest absolute difference."""
    width = got.shape[-1] if scale == "columns" else 1
    got, plain, f32 = (x.reshape(-1, width) for x in (got, plain, f32))
    if scale == "abs":
        s = torch.ones((1, 1), device=got.device)
    elif scale == "max":
        s = plain.abs().max().reshape(1, 1)
    else:
        s = plain.abs().amax(dim=0, keepdim=True)
    s = s.clamp_min(1e-30)
    d = (got - plain).abs() / s
    d32 = (f32 - plain).abs() / s
    frac = float((d > limit).float().mean())
    worst = float(d.max())
    mean, mean32 = d.mean(dim=0), d32.mean(dim=0)
    seen = float((mean32 / mean.clamp_min(1e-30)).min())
    log(f"{name} bf16 vs twin: beyond the float32 limit {limit:.0e}: "
        f"{frac:.3e} of {d.numel()} (limit {BF16_FLIP_FRAC:.0e}); max|d| "
        f"{worst:.3e} (limit {BF16_ULP:.0e}); mean|d| {float(mean.max()):.3e}"
        f", float32 kernel's {float(mean32.min()):.3e}: {seen:.3g}x "
        f"(limit {BF16_SEEN:.0f}x)" + (" in the worst column"
                                      if scale == "columns" else ""))
    if not (frac <= BF16_FLIP_FRAC and worst <= BF16_ULP
            and seen >= BF16_SEEN):
        raise RuntimeError(f"{name}: the bf16 branch disagrees with its "
                           f"plain twin or does not round")
    return float((got - plain).abs().max()) if got.numel() else 0.0


def run_stages(torch, what, mod, stages, timed):
    """Each (name, args, errs) of `stages`: the CUDA stage `mod.<name>_cuda`
    against its plain twin on the same args, `errs(cuda outputs, plain
    outputs)` giving {what: (error, limit or None where the check raised
    already)}; with `timed`, each stage's time. Returns {name: ms}."""
    times = {}
    for name, args, errs in stages:
        cuda, plain = getattr(mod, f"{name}_cuda"), getattr(mod, f"{name}_plain")
        got = cuda(*args)
        torch.cuda.synchronize()
        checked = errs(got, plain(*args))
        log(f"{what} stage {name} vs its plain twin: " + "  ".join(
            f"{k} {v:.3e}" + ("" if lim is None else f" (limit {lim:.0e})")
            for k, (v, lim) in checked.items()))
        if any(lim is not None and not v <= lim
               for v, lim in checked.values()):
            raise RuntimeError(f"stage {name} disagrees with its plain twin")
        if timed:
            times[name] = cuda_ms(lambda: cuda(*args), TIMED_LAUNCHES,
                                  WARM_LAUNCHES)
    if timed:
        log(f"{what} stage ms: " + "  ".join(f"{k} {v:.4f}"
                                            for k, v in times.items()))
    return times


def max_err(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def rel_err(a, b):
    """max|a - b| over max|b|."""
    return max_err(a, b) / max(float(b.abs().max()) if b.numel() else 0.0,
                               1e-30)


def check_stages(torch, FC, inputs, culled, timed, bf16=False):
    """Each CUDA stage of K1/K2 against its plain twin on the same inputs
    (the kernels' own intermediate state); with `timed`, each stage's
    time and (float32) the block passes' time with the cull defeated.
    `bf16` runs the stages of the blend_bf16 branch, each product held by
    check_bf16 beside the float32 stage on the same inputs. Returns the
    rows fwd_blocks staged in each block."""
    table, runs, count, geo, g_out, g_logt, logt, carry, live = inputs
    geo_b = (*geo, bf16)
    delta, acc, kept, sacc = FC.fwd_blocks_cuda(table, runs, count, *geo_b)
    S = FC.bwd_suffix_cuda(sacc, carry, live, runs, g_out, bf16)
    bwd_args = (table, runs, live, g_out, g_logt, logt, carry, S)
    if bf16:
        f32 = {"acc": FC.fwd_blocks_cuda(table, runs, count, *geo)[1],
               "S": FC.bwd_suffix_cuda(sacc, carry, live, runs, g_out),
               "dtab": FC.bwd_blocks_cuda(*bwd_args, *geo)}
    torch.cuda.synchronize()
    e = max_err
    ex = lambda a, b: e(torch.exp(a), torch.exp(b))  # noqa: E731

    def acc_errs(k, p):
        if not bf16:
            return {"acc": (e(k[1], p[1]), TOL_OUT)}
        return {w: (check_bf16(torch, f"K1 fwd_blocks {w}", k[i], p[i],
                               f32["acc"], TOL_OUT), None)
                for w, i in (("acc", 1), ("sacc", 3))}

    stages = [
        ("fwd_blocks", (table, runs, count, *geo_b),
         lambda k, p: {"exp(delta)": (ex(k[0], p[0]), TOL_ALPHA),
                       **acc_errs(k, p),
                       "rows kept differing": (e(k[2], p[2]), 0)}),
        ("fwd_scan", (delta, runs, count),
         lambda k, p: {"exp(carry)": (ex(k[0], p[0]), TOL_ALPHA),
                       "live flags differing": (e(k[1], p[1]), 0),
                       "alpha": (ex(k[2], p[2]), TOL_ALPHA)}),
        ("fwd_combine", (acc, carry, live, runs),
         lambda k, p: {"out": (e(k, p), TOL_OUT)}),
        ("bwd_suffix", (sacc, carry, live, runs, g_out, bf16),
         lambda k, p: {"S / max|S|": (
             (check_bf16(torch, "K2 bwd_suffix S", k, p, f32["S"],
                         TOL_DTAB_REL, "max"), None) if bf16
             else (rel_err(k, p), TOL_DTAB_REL))}),
        ("bwd_blocks", (*bwd_args, *geo_b),
         lambda k, p: {"dtab": (
             check_bf16(torch, "K2 bwd_blocks dtab", k, p, f32["dtab"],
                        TOL_DTAB_REL, "columns") if bf16
             else check_columns("bwd_blocks", k, p), None)}),
    ]
    times = run_stages(torch, "K1/K2 bf16" if bf16 else "K1/K2", FC, stages,
                       timed)
    if timed and not bf16:
        cull_off(torch, FC, inputs, culled, (delta, acc, S), times)
    return kept


def check_dense_stages(torch, C2, inputs, timed, bf16=False):
    """Each CUDA stage of K3/K4 against its plain twin on the same inputs
    (the kernels' own intermediate state): delta and acc of the chunks below
    ceil(count / B), which are all the chunk pass writes; the combine's log
    T, carries and nused exactly (the same deltas summed in the same
    order); S of the chunks below nused. With `timed`, each stage's time.
    `bf16` runs the stages of the blend_bf16 branch, each product held by
    check_bf16 beside the float32 stage on the same inputs."""
    table, counts, tile_ids, geo, g_out, g_logt = inputs
    B = geo[-1]
    geo_b = (*geo, bf16)
    nc = table.shape[1] // B
    delta, acc, sacc = C2.fwd_chunks_cuda(table, counts, tile_ids, *geo_b)
    _, logt, carries, nused = C2.fwd_combine_cuda(delta, acc, counts, B)
    S = C2.bwd_suffix_cuda(sacc, carries, nused, g_out, bf16)
    bwd_args = (table, nused, tile_ids, g_out, g_logt, logt, carries, S)
    if bf16:
        f32 = {"acc": C2.fwd_chunks_cuda(table, counts, tile_ids, *geo)[1],
               "S": C2.bwd_suffix_cuda(sacc, carries, nused, g_out),
               "dtab": C2.bwd_chunks_cuda(*bwd_args, *geo)}
    torch.cuda.synchronize()
    chunk = torch.arange(nc, device=table.device)[None, :]
    done = chunk < C2.n_chunks(counts, B, nc)[:, None]
    used = chunk < nused[:, None]
    e = max_err
    differ = lambda a, b: int((a != b).sum())  # noqa: E731

    def acc_errs(k, p):
        if not bf16:
            return {"acc": (e(k[1][done], p[1][done]), TOL_OUT)}
        return {w: (check_bf16(torch, f"K3 fwd_chunks {w}", k[i][done],
                               p[i][done], f32["acc"][done], TOL_OUT), None)
                for w, i in (("acc", 1), ("sacc", 2))}

    stages = [
        ("fwd_chunks", (table, counts, tile_ids, *geo_b),
         lambda k, p: {"exp(delta)": (e(torch.exp(k[0][done]),
                                        torch.exp(p[0][done])), TOL_ALPHA),
                       **acc_errs(k, p)}),
        ("fwd_combine", (delta, acc, counts, B),
         lambda k, p: {"out": (e(k[0], p[0]), TOL_OUT),
                       "log T differing": (differ(k[1], p[1]), 0),
                       "carries differing": (differ(k[2], p[2]), 0),
                       "nused differing": (differ(k[3], p[3]), 0)}),
        ("bwd_suffix", (sacc, carries, nused, g_out, bf16),
         lambda k, p: {"S / max|S|": (
             (check_bf16(torch, "K4 bwd_suffix S", k[used], p[used],
                         f32["S"][used], TOL_DTAB_REL, "max"), None) if bf16
             else (rel_err(k[used], p[used]), TOL_DTAB_REL))}),
        ("bwd_chunks", (*bwd_args, *geo_b),
         lambda k, p: {"dtab": (
             check_bf16(torch, "K4 bwd_chunks dtab", k, p, f32["dtab"],
                        TOL_DTAB_REL, "columns") if bf16
             else check_columns("bwd_chunks", k, p), None)}),
    ]
    run_stages(torch, "K3/K4 bf16" if bf16 else "K3/K4", C2, stages, timed)
    return int(done.sum())


def cull_off(torch, FC, inputs, culled, state, times):
    """fwd_blocks and bwd_blocks on a copy of the table whose culled rows
    have log_op raised from <= CULL_LOG_OP to just above it: alpha stays 0
    at every pixel (power <= log_op < log(1/255)), so every output must
    stay as it was, but no row is culled. The time against the stage times
    is what the cull saves."""
    table, runs, count, geo, g_out, g_logt, logt, carry, live = inputs
    delta, acc, S = state
    B = geo[-1]
    nc = table.clone()
    nc[culled.reshape(-1), 5] = FC.CULL_LOG_OP + 0.01
    bwd_args = (runs, live, g_out, g_logt, logt, carry, S, *geo)
    dtab = FC.bwd_blocks_cuda(table, *bwd_args)
    d_nc, a_nc, k_nc, _ = FC.fwd_blocks_cuda(nc, runs, count, *geo)
    dtab_nc = FC.bwd_blocks_cuda(nc, *bwd_args)
    torch.cuda.synchronize()
    full = bool((k_nc[count > 0] == B).all())
    err_d = float((torch.exp(d_nc) - torch.exp(delta)).abs().max())
    err_a = float((a_nc - acc).abs().max())
    log(f"cull defeated: every row of blocks with count > 0 staged: {full}; "
        f"against the cull on, max|d| exp(delta) {err_d:.3e}  acc "
        f"{err_a:.3e}  dtab {float((dtab_nc - dtab).abs().max()):.3e}")
    check_columns("bwd_blocks, cull defeated", dtab_nc, dtab)
    if not (full and err_d <= TOL_ALPHA and err_a <= TOL_OUT):
        raise RuntimeError("the cull changed fwd_blocks' outputs")
    off = {"fwd_blocks": cuda_ms(lambda: FC.fwd_blocks_cuda(
               nc, runs, count, *geo), TIMED_LAUNCHES, WARM_LAUNCHES),
           "bwd_blocks": cuda_ms(lambda: FC.bwd_blocks_cuda(nc, *bwd_args),
                                 TIMED_LAUNCHES, WARM_LAUNCHES)}
    log(f"cull defeated, {int(culled[count > 0].sum())} rows more staged: "
        + "  ".join(f"{k} {v:.4f} ms (cull on {times[k]:.4f}, saves "
                    f"{100 * (1 - times[k] / v):.1f}%)" for k, v in off.items()))


def check_kernels(torch, tr, tile_capacity, cover_tiles, timed):
    """K1/K2 against their plain versions on view 0's real table at the
    given pair budget and cover window, then each of their stages; with
    `timed`, also their times and bounds."""
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render import flat_composite as FC
    from fusionsense_tpu_torch.render.composite import TileGrid
    from fusionsense_tpu_torch.render.rasterize import (
        flat_table, gaussian_flat_normals,
    )
    from fusionsense_tpu_torch.train.trainer import patched_cfg

    cfg = patched_cfg(tr.cfg, tile_capacity, cover_tiles)
    rc = cfg.model.rasterize
    cam = tr.camera.index(0)
    n = tr.render_n
    with torch.no_grad():
        means, quats, scales, op, colors = (x[:n] for x in activated(tr.gaussians))
        ft = flat_table(means, quats, scales, op, colors, cam, rc,
                        normals=gaussian_flat_normals(quats, scales, means,
                                                      cam.origin))
    fb = ft.bins
    grid = TileGrid(cam.width, cam.height, rc.tile_size)
    T, P, B = grid.num_tiles, grid.pixels_per_tile, rc.pallas_chunk
    table = ft.table.contiguous()
    runs = FC.tile_runs(fb.blk_tile, T)
    count = fb.blk_count.contiguous()
    PB, W = table.shape
    nb, C = PB // B, W - 8
    geo = (T, grid.tiles_x, rc.tile_size, B)
    log(f"K1/K2 at tile_capacity {tile_capacity}, cover {cover_tiles}: "
        f"table {tuple(table.shape)}  tiles {T}+1  P {P}  blocks {nb}  "
        f"pairs_used {int(fb.used)}")

    fwd = lambda: FC.flat_composite_fwd_cuda(table, runs, count, *geo)  # noqa: E731
    fwd_p = lambda: FC.flat_composite_fwd_plain(table, runs, count, *geo)  # noqa: E731
    out, logt, carry, acc, live = fwd()
    torch.cuda.synchronize()
    out_p, logt_p, carry_p, _, live_p = fwd_p()
    err_out = float((out - out_p).abs().max())
    err_alpha = float((torch.exp(logt) - torch.exp(logt_p)).abs().max())
    err_carry = float((torch.exp(carry) - torch.exp(carry_p)).abs().max())
    log(f"K1 max|d|: out {err_out:.3e}  alpha {err_alpha:.3e}  "
        f"transmittance carries {err_carry:.3e}; live flags differing "
        f"{int((live != live_p).sum())}")
    if not (err_out <= TOL_OUT and err_alpha <= TOL_ALPHA
            and err_carry <= TOL_ALPHA and not bool((live != live_p).any())):
        raise RuntimeError("K1 disagrees with its plain version")

    gen = torch.Generator(device=table.device).manual_seed(0)
    g_out = G_SCALE * torch.randn((T + 1, C, P), generator=gen,
                                  device=table.device)
    g_logt = G_SCALE * torch.randn((T + 1, P), generator=gen,
                                   device=table.device)
    g_out[T] = 0.0
    g_logt[T] = 0.0
    tx, ts = grid.tiles_x, rc.tile_size
    bwd_args = (table, runs, g_out, g_logt, logt, carry, acc, live, tx, ts, B)
    bwd = lambda: FC.flat_composite_bwd_cuda(*bwd_args)  # noqa: E731
    bwd_p = lambda: FC.flat_composite_bwd_plain(*bwd_args)  # noqa: E731
    dtab = bwd()
    torch.cuda.synchronize()
    err_dtab = check_columns("K2", dtab, bwd_p())
    errs = {"fwd": max(err_out, err_alpha, err_carry), "bwd": err_dtab}
    # the plain cull, row by row (nb, B); the kernel's own count per block
    # is held against it in the fwd_blocks stage check
    culled = FC.cull_rows(table, FC.block_tiles(runs, nb), tx, ts, B)
    kept = check_stages(torch, FC, (table, runs, count, (tx, ts, B), g_out,
                                    g_logt, logt, carry, live), culled, timed)

    # the redesign's own numbers: the runs, the cull, the skip margin
    run_len = runs[1:T + 1] - runs[:T]
    staged_blocks = count > 0
    staged = staged_blocks.repeat_interleave(B)
    culled = culled.reshape(-1)
    n_alive = int(tr.gaussians.num_alive)      # alive-first: dead slots follow
    dead = fb.valid & (fb.gauss_ids >= n_alive)
    cmax = carry.max(dim=1).values
    margin = (cmax - FC.T_EPS_LOG).abs()[staged_blocks]
    at = int(torch.nonzero(staged_blocks)[int(margin.argmin())])
    log(f"by design fwd_blocks and bwd_blocks launch one CTA per block "
        f"({nb}); the scans walk a run's per-block state, longest run "
        f"{int(run_len.max())} blocks (tile {int(run_len.argmax())}), mean "
        f"{float(run_len.float().mean()):.2f}")
    n_staged = B * int(staged_blocks.sum())
    kernel_culled = n_staged - int(kept[staged_blocks].sum())
    if kernel_culled != int((culled & staged).sum()):
        raise RuntimeError("fwd_blocks culled other rows than cull_rows")
    log(f"cull: fwd_blocks staged {n_staged - kernel_culled} of the "
        f"{n_staged} rows of blocks with count > 0, culling {kernel_culled} "
        f"(per block as cull_rows); row by row, cull_rows culls "
        f"{int((culled & dead).sum())} pairs of dead slots (of "
        f"{int(dead.sum())}), {int((culled & staged & ~fb.valid).sum())} "
        f"padding rows and {int((culled & fb.valid & ~dead).sum())} live "
        f"pairs")
    log(f"smallest skip-decision margin |max_p carry - ({FC.T_EPS_LOG})|: "
        f"{float(margin.min()):.4e} at block {at}")
    if not timed:
        return errs, None

    # the blend_bf16 branch (N5) at the timed shape: K1/K2, then their
    # stages, against the plain twins
    fwd16 = lambda: FC.flat_composite_fwd_cuda(  # noqa: E731
        table, runs, count, *geo, blend_bf16=True)
    fwd16_p = lambda: FC.flat_composite_fwd_plain(  # noqa: E731
        table, runs, count, *geo, blend_bf16=True)
    o16, lt16, c16, a16, lv16 = fwd16()
    torch.cuda.synchronize()
    o16_p, lt16_p, _, _, lv16_p = fwd16_p()
    err_a16 = max_err(torch.exp(lt16), torch.exp(lt16_p))
    log(f"K1 bf16 max|d|: alpha {err_a16:.3e} (limit {TOL_ALPHA:.0e}); live "
        f"flags differing {int((lv16 != lv16_p).sum())}")
    if not (err_a16 <= TOL_ALPHA and torch.equal(lv16, lv16_p)):
        raise RuntimeError("K1's bf16 branch disagrees with its plain version")
    err16 = max(err_a16, check_bf16(torch, "K1 out", o16, o16_p, out,
                                    TOL_OUT))
    bwd16_args = (table, runs, g_out, g_logt, lt16, c16, a16, lv16, tx, ts, B)
    bwd16 = lambda: FC.flat_composite_bwd_cuda(  # noqa: E731
        *bwd16_args, blend_bf16=True)
    bwd16_p = lambda: FC.flat_composite_bwd_plain(  # noqa: E731
        *bwd16_args, blend_bf16=True)
    d16 = bwd16()
    d16_f32 = FC.flat_composite_bwd_cuda(*bwd16_args)
    torch.cuda.synchronize()
    errs16 = (err16, check_bf16(torch, "K2 dtab", d16, bwd16_p(), d16_f32,
                                TOL_DTAB_REL, "columns"))
    check_stages(torch, FC, (table, runs, count, (tx, ts, B), g_out, g_logt,
                             lt16, c16, lv16), None, timed, bf16=True)

    # work these inputs need: the pairs of the composited blocks that the
    # cull cannot prove zero (PR 1-2's bound counted every pair of them)
    live = live.bool()
    live_pairs = int((fb.valid & live.repeat_interleave(B) & ~culled).sum())
    ref_pairs = int(count[live].sum())
    live_blocks = int(live.sum())
    f4 = 4
    row_bytes = live_blocks * B * W * f4
    fwd_bytes = (row_bytes + 3 * nb * f4 + (T + 1) * (C + 1) * P * f4
                 + nb * P * f4)
    bwd_bytes = (row_bytes + 3 * nb * f4 + (T + 1) * (C + 2) * P * f4
                 + nb * P * f4 + PB * W * f4)
    fwd_bound, fwd_kind = bound(live_pairs * P * FWD_OPS, fwd_bytes)
    bwd_bound, bwd_kind = bound(live_pairs * P * BWD_OPS, bwd_bytes)
    ref = [bound(ref_pairs * P * ops, nbytes)[0]
           for ops, nbytes in ((FWD_OPS, fwd_bytes), (BWD_OPS, bwd_bytes))]
    log(f"live blocks {live_blocks}/{nb}: {ref_pairs} pairs, {live_pairs} "
        f"of them not culled (the bound's work); pairs of dead slots "
        f"{int(dead.sum())}; over all {ref_pairs} pairs (PR 1-2's bound) "
        f"K1 {ref[0]:.4f}, K2 {ref[1]:.4f} ms")
    entries = timed_entries("fusionsense_tpu_torch/csrc/flat_composite.cu", [
        ("flat_composite_fwd (K1)", "fusionsense_tpu/render/pallas_flat.py:52",
         fwd, fwd_p, fwd_bound, fwd_kind),
        ("flat_composite_bwd (K2)", "fusionsense_tpu/render/pallas_flat.py:93",
         bwd, bwd_p, bwd_bound, bwd_kind)])
    time_bf16(entries, ((fwd16, fwd16_p), (bwd16, bwd16_p)), errs16)
    return errs, entries


def check_dense_kernels(torch, tr, tile_capacity, cover_tiles, timed):
    """K3/K4 against their plain versions on view 0's real (T, K) table at
    the given K and cover window; with `timed`, also their times and
    bounds."""
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render import composite2 as C2
    from fusionsense_tpu_torch.render import flat_composite as FC
    from fusionsense_tpu_torch.render.composite import TileGrid
    from fusionsense_tpu_torch.render.rasterize import (
        dense_table, gaussian_flat_normals,
    )
    from fusionsense_tpu_torch.train.trainer import patched_cfg

    cfg = patched_cfg(tr.cfg, tile_capacity, cover_tiles)
    rc = cfg.model.rasterize
    cam = tr.camera.index(0)
    n = tr.render_n
    with torch.no_grad():
        means, quats, scales, op, colors = (x[:n] for x in activated(tr.gaussians))
        dt = dense_table(means, quats, scales, op, colors, cam, rc,
                         normals=gaussian_flat_normals(quats, scales, means,
                                                       cam.origin))
    grid = TileGrid(cam.width, cam.height, rc.tile_size)
    T, P, B = grid.num_tiles, grid.pixels_per_tile, rc.pallas_chunk
    table, counts = dt.table.contiguous(), dt.counts.contiguous()
    tile_ids = torch.arange(T, dtype=torch.int32, device=table.device)
    _, K, W = table.shape
    C, nc = W - 8, K // B
    tx, ts = grid.tiles_x, rc.tile_size
    log(f"K3/K4 at tile_capacity {tile_capacity}, cover {cover_tiles}: "
        f"table {tuple(table.shape)}  P {P}  live pairs {int(counts.sum())}  "
        f"full tiles {int((counts == K).sum())}  overflow {int(dt.bins.overflow)}")

    fwd = lambda: C2.composite2_fwd_cuda(table, counts, tile_ids, tx, ts, B)  # noqa: E731
    fwd_p = lambda: C2.composite2_fwd_plain(table, counts, tile_ids, tx, ts, B)  # noqa: E731
    out, logt, carries, nused, acc = fwd()
    torch.cuda.synchronize()
    out_p, logt_p, carries_p, nused_p, _ = fwd_p()
    if not torch.equal(nused, nused_p):
        raise RuntimeError(f"K3's nused differs from the plain version's in "
                           f"{int((nused != nused_p).sum())} tiles")
    written = torch.arange(nc, device=table.device)[None, :] < nused[:, None]
    err_out = float((out - out_p).abs().max())
    err_alpha = float((torch.exp(logt) - torch.exp(logt_p)).abs().max())
    err_carry = float((torch.exp(carries) - torch.exp(carries_p))
                      .abs()[written].max())
    log(f"K3 max|d|: out {err_out:.3e}  alpha {err_alpha:.3e}  written "
        f"transmittance carries {err_carry:.3e}; nused equal "
        f"(histogram {torch.bincount(nused.long(), minlength=nc + 1).tolist()})")
    if not (err_out <= TOL_OUT and err_alpha <= TOL_ALPHA
            and err_carry <= TOL_ALPHA):
        raise RuntimeError("K3 disagrees with its plain version")

    gen = torch.Generator(device=table.device).manual_seed(0)
    g_out = G_SCALE * torch.randn((T, C, P), generator=gen, device=table.device)
    g_logt = G_SCALE * torch.randn((T, P), generator=gen, device=table.device)
    bwd = lambda: C2.composite2_bwd_cuda(  # noqa: E731
        table, nused, tile_ids, g_out, g_logt, logt, carries, acc, tx, ts, B)
    bwd_p = lambda: C2.composite2_bwd_plain(  # noqa: E731
        table, nused, tile_ids, g_out, g_logt, logt, carries, acc, tx, ts, B)
    dtab = bwd()
    torch.cuda.synchronize()
    err_dtab = check_columns("K4", dtab, bwd_p())
    errs = {"fwd": max(err_out, err_alpha, err_carry), "bwd": err_dtab}
    passed = check_dense_stages(torch, C2, (table, counts, tile_ids,
                                            (tx, ts, B), g_out, g_logt),
                                timed)
    chunks = int(nused.sum())
    log(f"by design fwd_chunks and bwd_chunks launch one CTA per (tile, "
        f"chunk) ({T * nc}); fwd_chunks composited {passed} chunks, the "
        f"stop rule kept {chunks}: {passed - chunks} forward chunks "
        f"composited and discarded")
    if not timed:
        return errs, None

    # the blend_bf16 branch (N5) at the timed shape: K3/K4, then their
    # stages, against the plain twins
    fwd16 = lambda: C2.composite2_fwd_cuda(  # noqa: E731
        table, counts, tile_ids, tx, ts, B, blend_bf16=True)
    fwd16_p = lambda: C2.composite2_fwd_plain(  # noqa: E731
        table, counts, tile_ids, tx, ts, B, blend_bf16=True)
    o16, lt16, c16, n16, a16 = fwd16()
    torch.cuda.synchronize()
    o16_p, lt16_p, _, n16_p, _ = fwd16_p()
    err_a16 = max_err(torch.exp(lt16), torch.exp(lt16_p))
    log(f"K3 bf16 max|d|: alpha {err_a16:.3e} (limit {TOL_ALPHA:.0e}); "
        f"nused equal {bool(torch.equal(n16, n16_p))}")
    if not (err_a16 <= TOL_ALPHA and torch.equal(n16, n16_p)):
        raise RuntimeError("K3's bf16 branch disagrees with its plain version")
    err16 = max(err_a16, check_bf16(torch, "K3 out", o16, o16_p, out,
                                    TOL_OUT))
    bwd16_args = (table, n16, tile_ids, g_out, g_logt, lt16, c16, a16, tx, ts,
                  B)
    bwd16 = lambda: C2.composite2_bwd_cuda(  # noqa: E731
        *bwd16_args, blend_bf16=True)
    bwd16_p = lambda: C2.composite2_bwd_plain(  # noqa: E731
        *bwd16_args, blend_bf16=True)
    d16 = bwd16()
    d16_f32 = C2.composite2_bwd_cuda(*bwd16_args)
    torch.cuda.synchronize()
    errs16 = (err16, check_bf16(torch, "K4 dtab", d16, bwd16_p(), d16_f32,
                                TOL_DTAB_REL, "columns"))
    check_dense_stages(torch, C2, (table, counts, tile_ids, (tx, ts, B),
                                   g_out, g_logt), timed, bf16=True)

    # work these inputs need: the pairs of the chunks composited that the
    # flat compositor's row cull cannot prove zero (PR 2's bound counted
    # every pair of them)
    slot = torch.arange(K, device=table.device)[None, :]
    composited = (slot < counts[:, None]) & (slot < nused[:, None] * B)
    culled = FC.cull_rows(table.reshape(T * K, W), tile_ids, tx, ts,
                          K).reshape(T, K)
    live_pairs = int((composited & ~culled).sum())
    ref_pairs = int(composited.sum())
    f4 = 4
    row_bytes = chunks * B * W * f4
    fwd_bytes = (row_bytes + 2 * T * f4 + T * (C + 1) * P * f4
                 + chunks * P * f4 + T * f4)
    bwd_bytes = (row_bytes + 2 * T * f4 + T * (C + 2) * P * f4
                 + chunks * P * f4 + T * K * W * f4)
    fwd_bound, fwd_kind = bound(live_pairs * P * FWD_OPS, fwd_bytes)
    bwd_bound, bwd_kind = bound(live_pairs * P * BWD_OPS, bwd_bytes)
    ref = [bound(ref_pairs * P * ops, nbytes)[0]
           for ops, nbytes in ((FWD_OPS, fwd_bytes), (BWD_OPS, bwd_bytes))]
    log(f"composited chunks {chunks}/{T * nc}: {ref_pairs} pairs, "
        f"{live_pairs} of them not culled (the bound's work); over all "
        f"{ref_pairs} (PR 2's bound) K3 {ref[0]:.4f}, K4 {ref[1]:.4f} ms")
    entries = timed_entries("fusionsense_tpu_torch/csrc/composite2.cu", [
        ("composite2_fwd (K3)",
         "fusionsense_tpu/render/pallas_composite2.py:79",
         fwd, fwd_p, fwd_bound, fwd_kind),
        ("composite2_bwd (K4)",
         "fusionsense_tpu/render/pallas_composite2.py:128",
         bwd, bwd_p, bwd_bound, bwd_kind)])
    time_bf16(entries, ((fwd16, fwd16_p), (bwd16, bwd16_p)), errs16)
    return errs, entries


def profile_steps(torch, tr, name, step_ms, steps=5):
    """Device time by kernel over a few steps. The busy share divides the kernels' device time per step by the step time
    measured without the profiler, whose own host cost inflates wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.run(iterations=tr.step + steps, log=None)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    launches = sum(e.count for e in rows) / steps
    log(f"{name} profile: {steps} steps; device kernels {busy:.3f} ms/step in "
        f"{launches:.0f} launches/step; busy share of the unprofiled "
        f"{step_ms:.2f} ms step: {100 * busy / step_ms:.1f}%")
    for e in rows[:12]:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
            f"{e.count / steps:6.1f}/step  {e.key[:80]}")


def dense_config():
    """The dn_splatter preset with backend="pallas" at the bench's capacity,
    trained in chunks of 50 steps; the dense trainer bins every step."""
    from fusionsense_tpu_torch.presets import dn_splatter

    cfg = dn_splatter("pallas")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, capacity=CAPACITY),
        train=dataclasses.replace(cfg.train, scan_chunk=50,
                                  bin_refresh_steps=0))


def train_path(torch, tr, name, counters, kernels):
    """Trainer.run for WARM_STEPS, then to TRAIN_STEPS, timed, with every
    launch counter zeroed just before and read just after. `kernels` names
    the counters that must reach one launch per step. Returns the launch
    counts, ms/step over the timed steps, and the shape they ran at."""
    psnr_start = view_psnr(torch, tr, 0)
    shapes = [(0, tr.tile_capacity, tr.cover_tiles)]
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    tr.run(iterations=WARM_STEPS, log=log)
    torch.cuda.synchronize()
    # the timed steps are one chunk, so they all run at this shape
    timed_shape = (tr.tile_capacity, tr.cover_tiles)
    shapes.append((tr.step, *timed_shape))
    t1 = time.perf_counter()
    tr.run(iterations=TRAIN_STEPS, log=log)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    shapes.append((tr.step, tr.tile_capacity, tr.cover_tiles))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    psnr_end = view_psnr(torch, tr, 0)
    last = tr.history[-1]
    nonfinite = sum(r["nonfinite_steps"] for r in tr.history)
    ms_step = (t2 - t1) * 1e3 / (TRAIN_STEPS - WARM_STEPS)
    log(f"{name} train: {tr.step} steps; first {WARM_STEPS} took "
        f"{t1 - t0:.2f} s; last {TRAIN_STEPS - WARM_STEPS}: {ms_step:.2f} "
        f"ms/step; peak {peak_gb:.3f} GB; pairs_used {last['pairs_used']}; "
        f"alive {last['num_gaussians']}; (step, tile_capacity, cover) "
        f"{shapes}; overflow at the log boundaries "
        f"{[(r['step'], r['tile_overflow']) for r in tr.history]}; view-0 "
        f"PSNR {psnr_start:.3f} -> {psnr_end:.3f}; logged PSNR "
        f"{last['psnr']:.3f}; launches {launches}")
    if not (math.isfinite(last["loss"]) and nonfinite == 0):
        raise RuntimeError(f"{name}: non-finite training: loss {last['loss']}, "
                           f"{nonfinite} skipped steps")
    if not psnr_end > psnr_start:
        raise RuntimeError(f"{name}: PSNR did not improve: {psnr_start} -> "
                           f"{psnr_end}")
    if any(launches[k] < TRAIN_STEPS for k in kernels):
        raise RuntimeError(f"{name}: the main path missed a kernel: {launches}")
    if any(launches[f"{k}_plain"] for k in kernels):
        raise RuntimeError(f"{name}: the main path ran a plain version: "
                           f"{launches}")
    return launches, ms_step, timed_shape


def fused_config(cfg):
    """cfg with FUSED_ADC and its adaptive policies held still: run_fused,
    like the JAX package's fused path, runs none of them, so Trainer.run is
    held against it with them off (as tests/test_train_e2e.py:289 does)."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, auto_capacity=False, auto_tile_capacity=False,
        auto_cover_window=False,
        adc=dataclasses.replace(cfg.train.adc, **FUSED_ADC)))


def fused_path(torch, name, cfg, cams, data, init, dev, counters, kernels):
    """run_fused against Trainer.run on one configuration (phase 12): train
    eagerly to FUSED_FROM, copy the trainer, then (a) Trainer.run and (b)
    run_fused + sync_policies for FUSED_INTERVALS intervals of 50, refines
    at every interval end; n_alive and the alive masks equal, means within
    TOL_FUSED, last PSNR within TOL_FUSED_PSNR. (b) runs with the launch
    counters zeroed just before and read just after: `kernels` must launch
    once per step (graph replays counted by train/graphs.py), their plain
    twins never. Then one more interval under
    torch.cuda.set_sync_debug_mode("error") (refine included), two timed
    windows and one profiled interval. Returns the launches of (b)."""
    from fusionsense_tpu_torch.train import graphs as G
    from fusionsense_tpu_torch.train.trainer import Trainer, map_train_state
    from fusionsense_tpu_torch.utils import profiling

    cfg = fused_config(cfg)
    tr_a = Trainer(cfg, cams, data, init, device=dev)
    tr_a.run(iterations=FUSED_FROM, log=None)
    tr_b = Trainer(cfg, cams, data, init, device=dev)
    (tr_b.gaussians, tr_b.opt, tr_b.cam_state,
     tr_b.stats) = map_train_state(tr_a.gaussians, tr_a.opt, tr_a.cam_state,
                                   tr_a.stats, torch.clone)
    for k in ("step", "render_n", "tile_capacity", "cover_tiles"):
        setattr(tr_b, k, getattr(tr_a, k))
    steps = 50 * FUSED_INTERVALS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_a.run(iterations=FUSED_FROM + steps, log=None)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / steps

    for c in counters:
        c.reset_launch_counts()
    G.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ms = tr_b.run_fused(FUSED_INTERVALS, interval=50, block=True)
    first_s = time.perf_counter() - t0
    n_b = tr_b.sync_policies(ms)
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    for k, v in G.REPLAYED.items():
        launches[k] += v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = tr_b.graph_stats()
    pool = G.pool_bytes(tr_b._graph_pool)
    n_a = int(tr_a.gaussians.num_alive)
    same_alive = bool(torch.equal(tr_a.gaussians.alive, tr_b.gaussians.alive))
    means_err = float((tr_a.gaussians.means - tr_b.gaussians.means).abs().max())
    means_ok = bool(torch.allclose(tr_b.gaussians.means, tr_a.gaussians.means,
                                   **TOL_FUSED))
    psnr_a, psnr_b = tr_a.history[-1]["psnr"], tr_b.history[-1]["psnr"]
    log(f"{name} fused: steps {FUSED_FROM}-{tr_b.step} in {FUSED_INTERVALS} "
        f"intervals of 50 ({first_s:.2f} s with the captures); "
        f"{stats['graphs']} graphs captured in {stats['capture_s']:.2f} s, "
        f"graph pool {pool[1] / 1e6:.1f} MB reserved, {pool[0]} B allocated "
        f"after capture; peak {peak_gb:.3f} GB; n_alive eager {n_a} fused "
        f"{n_b}; alive masks equal {same_alive}; means max |diff| "
        f"{means_err:.3e}; last PSNR eager {psnr_a:.4f} fused {psnr_b:.4f}; "
        f"rows {[{k: v.tolist() for k, v in ms.items()}]}; launches "
        f"{launches}")
    if not (n_a == n_b and same_alive and means_ok
            and abs(psnr_a - psnr_b) <= TOL_FUSED_PSNR):
        raise RuntimeError(f"{name}: run_fused disagrees with Trainer.run")
    if any(launches[k] < steps for k in kernels):
        raise RuntimeError(f"{name} fused: the path missed a kernel: "
                           f"{launches}")
    if any(launches[f"{k}_plain"] for k in kernels):
        raise RuntimeError(f"{name} fused: the path ran a plain version: "
                           f"{launches}")
    del tr_a

    # no host sync in a fused interval, its refine and compaction included
    # (after one interval that captures the graphs of the policies' new key)
    tr_b.run_fused(1, interval=50)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr_b.run_fused(1, interval=50)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    def window(n):
        t0 = time.perf_counter()
        for _ in range(n):
            tr_b.run_fused(FUSED_WINDOW, interval=50)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t_a, t_b = window(1), window(3)
    ms_step = (t_b - t_a) * 1e3 / (2 * FUSED_WINDOW * 50)
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        tr_b.run_fused(1, interval=50)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels_n, rows = profiling.device_time(prof)
    calls = profiling.host_calls(prof)
    log(f"{name} fused timed: {ms_step:.3f} ms/step (windows of "
        f"{FUSED_WINDOW * 50} and {3 * FUSED_WINDOW * 50} steps: {t_a:.3f} s, "
        f"{t_b:.3f} s; slope), eager {eager_ms:.3f} ms/step (Trainer.run "
        f"above, {steps} steps); one profiled interval: {wall_ms / 50:.3f} "
        f"ms/step, device kernels {busy_ms / 50:.3f} ms/step in "
        f"{kernels_n / 50:.0f} kernels/step, {calls / 50:.1f} host launch "
        f"calls/step, device busy {100 * busy_ms / wall_ms:.1f}% of it")
    for e in rows[:8]:
        log(f"  {e.self_device_time_total / 1e3 / 50:8.3f} ms/step  "
            f"{e.count / 50:6.1f}/step  {e.key[:80]}")
    return launches


def fusionsense_config():
    """The fusionsense preset with backend="pallas" at the bench's capacity,
    scaled to FS_STEPS (FS_ADC, touch at FS_TOUCH_AT, margin FS_MARGIN)."""
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig
    from fusionsense_tpu_torch.presets import fusionsense

    cfg = fusionsense("pallas")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, capacity=CAPACITY,
                                       binary_opacity_margin=FS_MARGIN),
        train=dataclasses.replace(cfg.train, iterations=FS_STEPS,
                                  scan_chunk=FS_CHUNK, bin_refresh_steps=0,
                                  add_touch_at=FS_TOUCH_AT,
                                  adc=ADCConfig(**FS_ADC)))


def touch_callback(patches, anchor):
    """Anchor the patches at the first boundary at or past add_touch_at,
    touch_prune at every later one (the JAX full-schedule test's callback).
    `anchor` receives the boxes and the frozen-alive count after anchoring."""
    from fusionsense_tpu_torch.gaussians.touch import (
        add_touch_patches, touch_prune,
    )

    def cb(tr):
        if "boxes" not in anchor and tr.step >= tr.cfg.train.add_touch_at:
            tr.gaussians, tr.opt, anchor["boxes"] = add_touch_patches(
                tr.gaussians, tr.opt, patches, gel_scale=FS_GEL)
            anchor["step"] = tr.step
            anchor["frozen"] = frozen_alive(tr)
            anchor["free_before"] = tr.gaussians.capacity - (
                int(tr.gaussians.num_alive) - anchor["frozen"])
            return True
        if "boxes" in anchor:
            tr.gaussians = touch_prune(tr.gaussians, anchor["boxes"])
        return False
    return cb


def fs_schedule():
    """The refine steps of the fusionsense run and those that reset the
    opacities (at the chip's constants: 10 refines, resets at 300, 500)."""
    w, every = FS_ADC["warmup"], FS_ADC["refine_every"]
    steps = list(range(w, min(FS_ADC["stop_split_at"], FS_STEPS + 1), every))
    resets = [s for s in steps if (s - w) // every > 0
              and ((s - w) // every) % FS_ADC["reset_alpha_every"] == 0]
    return steps, resets


def frozen_alive(tr):
    return int((tr.gaussians.frozen & tr.gaussians.alive).sum())


def time_boundaries(torch, tr, refines):
    """Wrap tr.refine_boundary: time each refine boundary (refine,
    callbacks, recompact) with CUDA events and log its counts."""
    inner = tr.refine_boundary

    def timed():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        info = inner()
        end.record()
        torch.cuda.synchronize()
        if info is None:
            return None
        rec = {k: int(v) for k, v in info.items()}
        rec.update(step=tr.step, num_alive=int(tr.gaussians.num_alive),
                   capacity=tr.gaussians.capacity, render_n=tr.render_n,
                   K=tr.tile_capacity, cover=tr.cover_tiles,
                   ms=start.elapsed_time(end))
        if rec["opacity_reset"]:
            live = tr.gaussians.alive & ~tr.gaussians.frozen
            op = torch.sigmoid(tr.gaussians.logit_opacities)[live]
            rec["max_live_opacity"] = float(op.max()) if op.numel() else 0.0
        refines.append(rec)
        log("refine " + "  ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                  else f"{k} {v}" for k, v in rec.items()))
        return info

    tr.refine_boundary = timed


def step_losses(tr, n):
    """n more steps, one run each, so every step's loss is logged."""
    out = []
    for _ in range(n):
        tr.run(iterations=tr.step + 1, log=None)
        out.append(tr.history[-1]["loss"])
    return out


def fusionsense_path(torch, cams, data, init, dev, counters):
    """The whole FusionSense schedule through K3/K4 (phase 8). Returns the
    K3/K4 entries at the post-refine shape and their launches."""
    from fusionsense_tpu_torch.data.synthetic import sphere_touch_patches
    from fusionsense_tpu_torch.gaussians.io import (
        export_splat_ply, import_splat_ply,
    )
    from fusionsense_tpu_torch.train.trainer import Trainer

    cfg = fusionsense_config()
    patches = sphere_touch_patches(n_patches=FS_PATCHES,
                                   pts_per_patch=FS_PATCH_PTS)
    n_touch = FS_PATCHES * FS_PATCH_PTS
    fresh = lambda: init.replace(**{k: v.clone()  # noqa: E731
                                    for k, v in init.fields().items()})
    anchor = {}
    tr = Trainer(cfg, cams, data, fresh(), device=dev,
                 extra_callbacks=[touch_callback(patches, anchor)])
    refines = []
    time_boundaries(torch, tr, refines)
    log(f"fusionsense: capacity {tr.gaussians.capacity}, render_n "
        f"{tr.render_n}, K {tr.tile_capacity}, cover {tr.cover_tiles}; "
        f"{FS_STEPS} steps, ADC {FS_ADC}, touch at {FS_TOUCH_AT}, margin "
        f"{FS_MARGIN}")
    psnr_start = view_psnr(torch, tr, 0)
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(iterations=FS_STEPS, log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    psnr_end = view_psnr(torch, tr, 0)
    frozen_end = frozen_alive(tr)
    refine_ms = sum(r["ms"] for r in refines)
    resets = [r for r in refines if r["opacity_reset"]]
    nonfinite = sum(r["nonfinite_steps"] for r in tr.history)
    log(f"fusionsense train: {tr.step} steps in {secs:.2f} s, "
        f"{secs * 1e3 / FS_STEPS:.2f} ms/step (refine boundaries "
        f"{refine_ms:.1f} ms in all); peak {peak_gb:.3f} GB; alive "
        f"{int(tr.gaussians.num_alive)}, capacity {tr.gaussians.capacity}, "
        f"render_n {tr.render_n}, K {tr.tile_capacity}, cover "
        f"{tr.cover_tiles}; refines {len(refines)} at "
        f"{[r['step'] for r in refines]}; resets at "
        f"{[r['step'] for r in resets]}, largest live opacity after each "
        f"{[r['max_live_opacity'] for r in resets]}; touch anchored at step "
        f"{anchor.get('step')}: {anchor.get('frozen')} frozen-alive of "
        f"{n_touch} ({anchor.get('free_before')} free slots before), "
        f"{frozen_end} at the end; view-0 PSNR {psnr_start:.3f} -> "
        f"{psnr_end:.3f}; launches {launches}")
    if not (math.isfinite(tr.history[-1]["loss"]) and nonfinite == 0):
        raise RuntimeError(f"fusionsense: non-finite training ({nonfinite} "
                           f"skipped steps)")
    want_refines, want_resets = fs_schedule()
    if [r["step"] for r in refines] != want_refines:
        raise RuntimeError(f"fusionsense: refines at "
                           f"{[r['step'] for r in refines]}, want "
                           f"{want_refines}")
    if ([r["step"] for r in resets] != want_resets
            or any(r["max_live_opacity"] > RESET_CEIL for r in resets)):
        raise RuntimeError(f"fusionsense: the opacity resets did not clamp: "
                           f"{resets}")
    want_frozen = min(n_touch, anchor.get("free_before", 0))
    if anchor.get("frozen") != want_frozen or frozen_end != want_frozen:
        raise RuntimeError(f"fusionsense: frozen-alive {anchor.get('frozen')}"
                           f" after anchoring, {frozen_end} at the end, want "
                           f"{want_frozen}")
    if want_frozen != n_touch:
        log(f"fusionsense: only {want_frozen} of {n_touch} patch points found "
            f"a free slot")
    if not psnr_end > psnr_start:
        raise RuntimeError(f"fusionsense: PSNR did not improve: {psnr_start} "
                           f"-> {psnr_end}")
    names = ("composite2_fwd", "composite2_bwd")
    if any(launches[k] < FS_STEPS for k in names) or any(
            launches[f"{k}_plain"] for k in names):
        raise RuntimeError(f"fusionsense: the path missed a kernel or ran a "
                           f"plain version: {launches}")

    # K3/K4 at the shape the grown population gives them
    errs, entries = check_dense_kernels(torch, tr, tr.tile_capacity,
                                        tr.cover_tiles, timed=True)
    for k, key in zip(entries, ("fwd", "bwd")):
        k["max_abs_err"] = errs[key]

    # checkpoint, restore into a fresh trainer, 10 more steps from each
    SCRATCH.mkdir(parents=True, exist_ok=True)
    ckpt = SCRATCH / f"ckpt_{tr.step}"
    tr.save(ckpt)
    tr2 = Trainer(cfg, cams, data, fresh(), device=dev,
                  extra_callbacks=[touch_callback(patches, dict(anchor))])
    tr2.restore(ckpt)
    if (tr2.step, tr2.render_n, tr2.tile_capacity, tr2.cover_tiles) != (
            tr.step, tr.render_n, tr.tile_capacity, tr.cover_tiles):
        raise RuntimeError("the restored trainer's policy state differs")
    la, lb = step_losses(tr, RESUME_STEPS), step_losses(tr2, RESUME_STEPS)
    rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    log(f"resume: {RESUME_STEPS} steps from step {FS_STEPS} in the trained "
        f"and the restored trainer; losses {[f'{x:.6f}' for x in la]}; "
        f"largest relative difference {rel:.3e} (limit {TOL_RESUME:.0e})")
    if not rel <= TOL_RESUME:
        raise RuntimeError("the resumed run disagrees with the trained one")

    # the splat PLY, written and read back
    n_alive = int(tr.gaussians.num_alive)
    n_ply = export_splat_ply(SCRATCH / "splat.ply", tr.gaussians)
    back = import_splat_ply(SCRATCH / "splat.ply", device=dev)
    alive = tr.gaussians.alive
    err_ply = float((back.means[:n_ply] - tr.gaussians.means[alive]).abs().max())
    log(f"splat PLY: {n_ply} Gaussians written, {int(back.num_alive)} read "
        f"back, num_alive {n_alive}; max|d| means {err_ply:.3e}")
    if not (n_ply == n_alive == int(back.num_alive) and err_ply == 0.0):
        raise RuntimeError("the splat PLY does not hold the alive Gaussians")

    # camera optimisation and the SDF loss on the trained state
    cfg3 = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, camera_opt=True,
                                       camera_opt_every_k=10),
        loss=dataclasses.replace(cfg.loss, sdf_lambda=0.1))
    tr3 = Trainer(cfg3, cams, data, fresh(), device=dev,
                  extra_callbacks=[touch_callback(patches, dict(anchor))])
    tr3.restore(ckpt)
    losses = step_losses(tr3, CAM_STEPS)
    dmax = float(tr3.cam_state[0].abs().max())
    log(f"camera_opt (every 10) + sdf_lambda 0.1: {CAM_STEPS} steps from "
        f"step {FS_STEPS}; losses {[f'{x:.5f}' for x in losses]}; largest "
        f"|delta| {dmax:.3e}")
    if not (all(math.isfinite(x) for x in losses) and dmax > 0):
        raise RuntimeError("camera optimisation / SDF loss failed")
    return entries, launches, tr


def extract_counted(torch, tr, method, cams, counters, out_dir, kernel, res):
    """mesh_export.extract on a trainer's Gaussians at its own render config
    (grown K or pair budget, cover window), timed with CUDA
    synchronisation, the launch counters zeroed just before and read just
    after. A method that renders must launch `kernel` at least once per
    view and its plain twin never; every method must give a non-empty,
    finite mesh that its PLY holds. Returns (verts, faces, seconds,
    launches)."""
    import numpy as np

    from fusionsense_tpu_torch.mesh_export import RENDERING, extract
    from fusionsense_tpu_torch.train.trainer import patched_cfg
    from fusionsense_tpu_torch.utils.ply import read_ply

    rc = patched_cfg(tr.cfg, tr.tile_capacity, tr.cover_tiles).model.rasterize
    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verts, faces, path = extract(method, tr.gaussians, cams, rc, out_dir,
                                 resolution=res)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    ply = read_ply(path)
    ok = (len(faces) > 0 and np.isfinite(verts).all()
          and len(ply["points"]) == len(verts)
          and len(ply["faces"]) == len(faces))
    views = cams.viewmat.shape[0]
    renders = method in RENDERING
    if not ok or launches[f"{kernel}_plain"] or (
            renders and launches[kernel] < views):
        raise RuntimeError(f"mesh {method}: {len(verts)} verts, "
                           f"{len(faces)} faces, PLY {path.name} holds "
                           f"{len(ply['points'])}; launches {launches}")
    return verts, faces, secs, launches


def mesh_path(torch, tr, tr_flat, cams, counters, card):
    """The mesh phase: mesh_export.extract with each of its five methods at
    their defaults on the fusionsense path's trained model (renders through
    K3), then tsdf on the flat path's model (K1); seconds, verts, faces and
    launches per method, and the tsdf meshes' chamfer x 1e3 against the GT
    sphere. Returns the K1 and K3 launches of the phase."""
    from fusionsense_tpu_torch.data.synthetic import sphere_gt
    from fusionsense_tpu_torch.eval.chamfer import chamfer_eval
    from fusionsense_tpu_torch.mesh_export import METHODS

    gt = sphere_gt(N_SPHERE)
    out = SCRATCH / "mesh"
    total = {"flat_composite_fwd": 0, "composite2_fwd": 0}
    rows = []
    runs = [(tr, m, "composite2_fwd", "fusionsense") for m in METHODS]
    runs.append((tr_flat, "tsdf", "flat_composite_fwd", "flat"))
    log(f"mesh phase at resolution {MESH_RES} ({card}): fusionsense model "
        f"{int(tr.gaussians.num_alive)} alive (capacity "
        f"{tr.gaussians.capacity}, K {tr.tile_capacity}), flat model "
        f"{int(tr_flat.gaussians.num_alive)} alive")
    for trainer, method, kernel, model in runs:
        verts, faces, secs, launches = extract_counted(
            torch, trainer, method, cams, counters, out / model, kernel,
            MESH_RES)
        total[kernel] += launches[kernel]
        cham = ("" if method != "tsdf" else ", chamfer x1e3 "
                f"{chamfer_eval(verts, gt)['chamfer_x1e3']:.4f} vs the GT "
                "sphere")
        log(f"  mesh {method:12s} ({model} model): {secs:8.3f} s, "
            f"{len(verts)} verts, {len(faces)} faces, {launches[kernel]} "
            f"{kernel} launches{cham}")
    return total


def installations():
    """Whether Pillow, scipy, scikit-learn and imageio import here (the
    port's path needs Pillow and scipy; fs-render's --video, which this
    script does not pass, needs imageio)."""
    import importlib

    found = {}
    for name in ("PIL", "scipy", "sklearn", "imageio"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def jax_backend_path(torch, cams, data, init, dev, counters, card):
    """The dn_splatter preset with backend="jax" (fs-train's default: the
    plain PyTorch compositor, no kernel of K1-K4) on the bench scene."""
    from fusionsense_tpu_torch.presets import dn_splatter
    from fusionsense_tpu_torch.train.trainer import Trainer

    cfg = dn_splatter("jax")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, capacity=CAPACITY),
        train=dataclasses.replace(cfg.train, scan_chunk=50,
                                  bin_refresh_steps=0))
    tr = Trainer(cfg, cams, data, init, device=dev)
    log(f"jax backend: capacity {tr.gaussians.capacity}, render_n "
        f"{tr.render_n}, tile_capacity {tr.tile_capacity}; {card}")
    launches, _, _ = train_path(torch, tr, "jax backend", counters, ())
    if any(launches.values()):
        raise RuntimeError(f"jax backend: a kernel launched: {launches}")


def _timed_calls(torch, targets, times, results):
    """Wrap each (owner, name) so its calls are timed, device synchronised,
    into times[name] and their last result kept in results[name]. Returns
    the originals, to put back."""
    saved = []
    for owner, name in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def timed(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times[_name] = times.get(_name, 0.0) + time.perf_counter() - t0
            results[_name] = out
            return out
        setattr(owner, name, timed)
    return saved


def pipeline_path(torch, dev, counters, card):
    """fs-train in the port, end to end from a capture on disk (phase 11):
    the blob capture written on the card, its seed cloud dropped so the
    visual hull and the seed cloud from depth both run; then
    cli.train.main with the pallas backend (K3/K4) for PIPE_ITERS steps and
    its default meshes, and a second main resumed from the mid-run
    checkpoint. Every artifact is read back through the port's own
    readers; then K3/K4 are held against their plain versions on the first
    run's trained state, and fs-mesh and fs-eval run on its last
    checkpoint. Returns the K3/K4 launches of both runs (and, under
    cli_composite2_fwd, K3's of fs-mesh and fs-eval) and those checks'
    errors."""
    import shutil

    import numpy as np

    from fusionsense_tpu_torch import pipeline as P
    from fusionsense_tpu_torch.cli.eval import main as fs_eval
    from fusionsense_tpu_torch.cli.mesh import main as fs_mesh
    from fusionsense_tpu_torch.cli.train import main as fs_train
    from fusionsense_tpu_torch.data.fixture import write_blob_scene
    from fusionsense_tpu_torch.data.image_io import read_image
    from fusionsense_tpu_torch.train.checkpoint import load_checkpoint
    from fusionsense_tpu_torch.utils.ply import read_pcd, read_ply

    scene, out_root = SCRATCH / "blob", SCRATCH / "pipeline"
    for d in (scene, out_root):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    write_blob_scene(scene, n_views=N_VIEWS, width=WIDTH, height=HEIGHT,
                     focal=FOCAL, device=dev)
    torch.cuda.synchronize()
    log(f"pipeline: blob capture {N_VIEWS} views at {WIDTH}x{HEIGHT}, focal "
        f"{FOCAL}, written in {time.perf_counter() - t0:.2f} s; {card}")
    tj = scene / "transforms.json"
    meta = json.loads(tj.read_text())
    meta.pop("ply_file_path")          # the hull and the seed cloud both run
    tj.write_text(json.dumps(meta))

    times, results, entries = {}, {}, []
    run = P.Trainer.run

    def run_logged(tr, *a, **kw):      # (step, frozen-alive) on entry
        entries.append((tr.step, frozen_alive(tr)))
        return run(tr, *a, **kw)
    P.Trainer.run = run_logged
    saved = [(P.Trainer, "run", run)] + _timed_calls(torch, [
        (P, "parse_transforms"), (P, "load_train_data"), (P, "visual_hull"),
        (P, "seed_pcd_from_depths"), (P, "init_from_points"),
        (P, "export_high_grad_pcd"), (P, "evaluate"), (P.Trainer, "run"),
        (P.ReconstructionPipeline, "extract_mesh")], times, results)
    # the CLI's default --mesh (tsdf sugar-coarse)
    args = ["--load-touches", "--backend", "pallas", "--iterations",
            str(PIPE_ITERS), "--warmup-length", str(PIPE_WARMUP),
            "--stop-split-at", str(PIPE_STOP_SPLIT), "--add-touch-at",
            str(PIPE_TOUCH_AT), "--steps-per-save", str(PIPE_SAVE)]
    out = out_root / "dn_splatter"
    try:
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset_launch_counts()
        pipe = fs_train(["--data", str(scene), "--output-dir", str(out_root),
                         *args], device=dev)
        torch.cuda.synchronize()
        first = dict(times)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_hull = len(results["visual_hull"])
        n_seed = len(results["seed_pcd_from_depths"][0])
        n_init = int(results["init_from_points"].num_alive)
        n_high = results["export_high_grad_pcd"]
        frozen_end = frozen_alive(pipe.trainer)
        hist = pipe.trainer.history
        times.clear()
        resume = out / f"ckpt_{PIPE_SAVE}"
        args[args.index("--iterations") + 1] = str(PIPE_RESUME_ITERS)
        pipe2 = fs_train(["--data", str(scene), "--output-dir", str(out_root),
                          "--experiment-name", "resume", "--resume",
                          str(resume), *args, "--mesh"], device=dev)
        torch.cuda.synchronize()
        n_high2 = results["export_high_grad_pcd"]
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    # K3/K4 against their plain versions at the shape this trainer gave them,
    # and timed there
    log(f"pipeline: K3/K4 on the first run's state at step "
        f"{pipe.trainer.step} ({int(pipe.trainer.gaussians.num_alive)} alive)")
    errs, _ = check_dense_kernels(torch, pipe.trainer, pipe.trainer.tile_capacity,
                                  pipe.trainer.cover_tiles, timed=True)

    res = json.loads((out / "metrics.json").read_text())
    grids = sorted((out / "log_images").glob("step_*.png"))
    shapes = {read_image(g).shape for g in grids}
    fg, merged = read_ply(out / "foreground_pcd.ply"), read_ply(
        out / "merged_pcd.ply")
    high = read_pcd(out / "high_grad_pts.pcd")
    # the resumed run exports from the settled population (step 300 on)
    high2 = read_pcd(out_root / "resume" / "high_grad_pts.pcd")
    clusters = np.unique(high2["cluster"]) if n_high2 else np.zeros(0)
    ranks = np.unique(high2["grad_rank"]) if n_high2 else np.zeros(0)
    ckpts = {}
    for s in (PIPE_SAVE, PIPE_ITERS):      # (step, alive) read back
        g, _, _, step = load_checkpoint(out / f"ckpt_{s}", device=dev)
        ckpts[s] = (step, int(g.num_alive))
    stage_s = {
        "parse+load": first["parse_transforms"] + first["load_train_data"],
        "hull": first["visual_hull"], "seed cloud": first["seed_pcd_from_depths"],
        "train": first["run"], "high-grad export": first["export_high_grad_pcd"],
        "mesh (tsdf, sugar-coarse)": first["extract_mesh"],
        "eval": first["evaluate"]}
    mean = res["mean"]
    log(f"pipeline stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
        + f"; train {1e3 * (first['run'] - first['export_high_grad_pcd']) / PIPE_ITERS:.2f}"
        f" ms/step (the high-grad export taken out); peak {peak_gb:.3f} GB; "
        f"{card}")
    log(f"pipeline: hull {n_hull} points, seed cloud {n_seed}, {n_init} after "
        f"the capacity stride; high-grad {n_high} points at step "
        f"{PIPE_STOP_SPLIT - 500}, {n_high2} in the resumed run ({len(clusters)}"
        f" clusters, ranks {ranks.astype(int).tolist()}); debug grids "
        f"{len(grids)} {sorted(shapes)}; touch frozen-alive {frozen_end}; "
        f"checkpoints (step, alive) {ckpts}; K3/K4 launches {launches}")
    log(f"pipeline metrics.json mean: "
        + ", ".join(f"{k} {mean[k]:.4f}" for k in PIPE_METRICS)
        + f"; logged PSNR {hist[0]['psnr']:.3f} (step {hist[0]['step']}) -> "
        f"{hist[-1]['psnr']:.3f} (step {hist[-1]['step']})")
    log(f"pipeline resume: trainer entered at (step, frozen-alive) "
        f"{entries[-1]}; {pipe2.trainer.step} steps at the end; "
        f"{1e3 * times['run'] / (PIPE_RESUME_ITERS - PIPE_SAVE):.2f} ms/step")

    if not (len(fg["points"]) == n_hull > 0 and len(merged["points"]) == n_seed
            and len(high["points"]) == n_high):
        raise RuntimeError("pipeline: a prior's file does not hold its points")
    if not grids or shapes != {(HEIGHT, 4 * WIDTH, 3)}:
        raise RuntimeError(f"pipeline: debug grids {len(grids)} {shapes}")
    if not all(step == s and n > 0 for s, (step, n) in ckpts.items()):
        raise RuntimeError(f"pipeline: checkpoints {ckpts}")
    if not all(math.isfinite(v) for v in mean.values()):
        raise RuntimeError(f"pipeline: a metric is not finite: {mean}")
    if not hist[-1]["psnr"] > hist[0]["psnr"]:
        raise RuntimeError("pipeline: the logged PSNR did not rise")
    names = ("composite2_fwd", "composite2_bwd")
    if any(launches[k] < PIPE_ITERS for k in names) or any(
            launches[f"{k}_plain"] for k in names):
        raise RuntimeError(f"pipeline: the path missed K3/K4 or ran a plain "
                           f"version: {launches}")
    if not (entries[-1] == (PIPE_SAVE, frozen_end) and frozen_end > 0
            and pipe2.trainer.step == PIPE_RESUME_ITERS
            and frozen_alive(pipe2.trainer) == frozen_end):
        raise RuntimeError(f"pipeline: the resumed run entered at "
                           f"{entries[-1]}, want ({PIPE_SAVE}, {frozen_end})")
    if not np.isfinite(high["points"]).all():
        raise RuntimeError("pipeline: non-finite high-grad points")
    meshes = {m: read_ply(out / f) for m, f in (
        ("tsdf", "mesh_tsdf.ply"),
        ("sugar-coarse", "mesh_sugar-coarse_level_0.3.ply"))}
    log("pipeline meshes (the CLI's default --mesh): " + ", ".join(
        f"{m} {len(v['points'])} verts, {len(v['faces'])} faces"
        for m, v in meshes.items()))
    if not all(len(v["faces"]) and np.isfinite(v["points"]).all()
               for v in meshes.values()):
        raise RuntimeError("pipeline: a mesh of the default --mesh is empty")

    # fs-mesh and fs-eval on the saved checkpoint, each rendering every
    # train view through K3, never its plain twin
    ckpt = str(out / f"ckpt_{PIPE_ITERS}")
    views = pipe.camera.viewmat.shape[0]

    def counted(fn, argv):
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(argv, device=dev)
        torch.cuda.synchronize()
        n = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        if n["composite2_fwd"] < views or n["composite2_fwd_plain"]:
            raise RuntimeError(f"pipeline: {fn.__module__} missed K3 or ran "
                               f"its plain version: {n}")
        return res, time.perf_counter() - t0, n["composite2_fwd"]

    ((mv, mf, mpath),), mesh_s, mesh_k3 = counted(fs_mesh, [
        "tsdf", "--checkpoint", ckpt, "--data", str(scene), "--output-dir",
        str(out_root / "fs_mesh"), "--backend", "pallas", "--tile-capacity",
        str(pipe.trainer.tile_capacity)])
    ev, eval_s, eval_k3 = counted(fs_eval, [
        "--checkpoint", ckpt, "--data", str(scene), "--output-path",
        str(out_root / "fs_eval.json"), "--backend", "pallas"])
    log(f"fs-mesh tsdf: {mesh_s:.3f} s, {len(mv)} verts, {len(mf)} faces -> "
        f"{mpath.name}, K3 launches {mesh_k3}; fs-eval: {eval_s:.3f} s, K3 "
        f"launches {eval_k3}, step {ev['step']}, "
        + ", ".join(f"{k} {ev['mean'][k]:.4f}" for k in PIPE_METRICS))
    if not (len(mf) and np.isfinite(mv).all() and ev["step"] == PIPE_ITERS
            and all(math.isfinite(v) for v in ev["mean"].values())):
        raise RuntimeError("pipeline: fs-mesh or fs-eval failed")
    launches["cli_composite2_fwd"] = mesh_k3 + eval_k3
    if not (n_high2 > 0 and len(high2["points"]) == n_high2
            and np.isfinite(high2["points"]).all() and (clusters >= 0).all()
            and ranks.tolist() == list(range(len(clusters)))):
        raise RuntimeError(f"pipeline: the resumed run's high-grad export: "
                           f"{n_high2} points, clusters {clusters.tolist()}, "
                           f"ranks {ranks.tolist()}")
    return launches, errs


def _event_ms(torch, fn, n=3):
    """Mean CUDA-event ms of fn() over n calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _past_limit(got, want, kind):
    """(max |got - want|, share of pixels past the phase's limit)."""
    import numpy as np

    d = np.abs(got - want)
    if kind == "normal":
        past = d.max(-1) > PRIOR_NORMAL_ATOL
    else:
        past = d > PRIOR_DEPTH_RTOL * np.abs(want)
    return float(d.max()), float(past.mean())


def prior_nets(torch, dev, out):
    """The three prior nets at their default widths: one seeded state dict
    each, written as the published file wraps it and loaded back through
    the port's load_*_checkpoint, once for the card and once for the CPU.
    Returns {name: (card predictor, CPU predictor)}."""
    from fusionsense_tpu_torch.priors import weights as PW
    from fusionsense_tpu_torch.priors.depth_anything import (
        DAConfig, DepthAnything, DepthAnythingModel,
    )
    from fusionsense_tpu_torch.priors.depth_anything.convert import (
        load_da_checkpoint,
    )
    from fusionsense_tpu_torch.priors.dsine import DSINE, DSinePredictor
    from fusionsense_tpu_torch.priors.dsine.convert import load_dsine_checkpoint
    from fusionsense_tpu_torch.priors.dsine.model import DSINEConfig
    from fusionsense_tpu_torch.priors.metric3d import (
        M3DConfig, Metric3D, Metric3DPredictor,
    )
    from fusionsense_tpu_torch.priors.metric3d.convert import (
        load_metric3d_checkpoint,
    )

    specs = {
        "dsine": (lambda: DSINE(DSINEConfig()), "model",
                  load_dsine_checkpoint,
                  lambda net, d: DSinePredictor(net, device=d)),
        "metric3d": (lambda: Metric3D(M3DConfig()), "model_state_dict",
                     load_metric3d_checkpoint,
                     lambda net, d: Metric3DPredictor(net, device=d)),
        "depth_anything": (lambda: DepthAnything(DAConfig()), "state_dict",
                           load_da_checkpoint,
                           lambda net, d: DepthAnythingModel(net, device=d)),
    }
    preds = {}
    for i, (name, (make, wrap, load, predictor)) in enumerate(specs.items()):
        sd = PW.random_state_dict(make(), seed=PRIOR_SEED + i, std=None)
        if name == "depth_anything":
            sd["depth_head.scratch.output_conv2.2.bias"] += DA_BIAS_LIFT
        path = out / f"{name}.pt"
        torch.save({wrap: sd}, path)
        preds[name] = (predictor(load(str(path)), dev),
                       predictor(load(str(path)), "cpu"))
        log(f"priors: {name} {sum(v.numel() for v in sd.values()) / 1e6:.2f} M "
            f"parameters, loaded from {path.name}")
    return preds


def _tf32_everywhere():
    """The predictors' nets with TF32 allowed in cuDNN convolutions and
    matmuls (the phase allows both flags): their full_float32 context
    replaced by a no-op. Returns an undo function."""
    import contextlib

    from fusionsense_tpu_torch.priors.depth_anything import predictor as PA
    from fusionsense_tpu_torch.priors.dsine import predictor as PD
    from fusionsense_tpu_torch.priors.metric3d import predictor as PM

    mods = (PA, PD, PM)
    saved = [m.full_float32 for m in mods]
    for m in mods:
        m.full_float32 = contextlib.nullcontext

    def undo():
        for m, f in zip(mods, saved):
            m.full_float32 = f
    return undo


def priors_path(torch, dev, card, capture):
    """The monocular priors (phase 13) on the pipeline phase's capture:
    generate_priors with Metric3D depth and DSINE normals over every frame
    (the artifacts read back), Depth-Anything's depth aligned onto the
    sensor depth by align_mono_depths, and for view 0 of each net the card
    against the CPU (the predictors' float32, and with TF32 allowed), ms
    per frame and peak memory. TF32 is allowed for the phase in cuDNN's
    convolutions (PyTorch's default) and in CUDA matmuls, so the
    predictors' own float32 context is what is measured."""
    import shutil

    import numpy as np

    from fusionsense_tpu_torch.data.dataparser import load_depth, load_rgb
    from fusionsense_tpu_torch.priors.depth_align import align_mono_depths
    from fusionsense_tpu_torch.priors.mono_priors import generate_priors

    out = SCRATCH / "priors"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    scene = out / "scene"
    shutil.copytree(capture, scene)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        preds = prior_nets(torch, dev, out)
        dsine, m3d, da = (preds[k] for k in ("dsine", "metric3d",
                                             "depth_anything"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = generate_priors(scene, depth_model=m3d[0], normal_model=dsine[0],
                               device=dev)
        gen_s = time.perf_counter() - t0
        frames = meta["frames"]
        depths = [np.load(scene / fr["mono_depth_file_path"]) for fr in frames]
        normals = [np.load(scene / fr["normal_file_path"]) for fr in frames]
        patched = json.loads((scene / "transforms.json").read_text())["frames"]
        d_all, n_all = np.stack(depths), np.stack(normals)
        unit = float(np.abs(np.linalg.norm(n_all, axis=-1) - 1).max())
        log(f"priors: generate_priors over {len(frames)} frames at "
            f"{WIDTH}x{HEIGHT} (Metric3D depth, DSINE normals): {gen_s:.3f} s, "
            f"{1e3 * gen_s / len(frames):.1f} ms/frame; depth {d_all.shape} "
            f"in [{d_all.min():.4f}, {d_all.max():.4f}] m, normals "
            f"{n_all.shape} | |n| - 1 | <= {unit:.2e}; {card}")
        if not (len(patched) == len(frames) and all(
                "mono_depth_file_path" in f and "normal_file_path" in f
                for f in patched)):
            raise RuntimeError("priors: transforms.json was not patched")
        if not (d_all.shape == (len(frames), HEIGHT, WIDTH)
                and n_all.shape == (len(frames), HEIGHT, WIDTH, 3)
                and np.isfinite(d_all).all() and d_all.min() >= 0
                and d_all.max() <= PRIOR_DEPTH_CLAMP and unit <= PRIOR_UNIT_TOL):
            raise RuntimeError("priors: an artifact is out of its range")

        # Depth-Anything's depth aligned onto the sensor depth
        fx = frames[0].get("fl_x", meta.get("fl_x"))
        rgbs = [load_rgb(scene / fr["file_path"]) for fr in frames]
        sensor = np.stack([load_depth(scene / fr["depth_file_path"])
                           for fr in frames])
        mono = np.stack([da[0].predict_depth(rgb, fx) for rgb in rgbs])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aligned = align_mono_depths(mono, sensor, device=dev)
        torch.cuda.synchronize()
        align_s = time.perf_counter() - t0
        aligned = aligned.cpu().numpy()
        valid = sensor > 0.1
        before = float(np.median(np.abs(mono - sensor)[valid] / sensor[valid]))
        after = float(np.median(np.abs(aligned - sensor)[valid] / sensor[valid]))
        log(f"priors: align_mono_depths of Depth-Anything's depth onto the "
            f"sensor depth, {len(frames)} frames: {align_s:.3f} s; median "
            f"|d - sensor| / sensor {before:.4f} -> {after:.4f}")
        if not (np.isfinite(aligned).all() and aligned.shape == sensor.shape
                and after < before):
            raise RuntimeError("priors: the aligned depth is not finite or "
                               "not closer to the sensor")

        # view 0: card against CPU, TF32 off (the predictors') and allowed
        rgb0 = rgbs[0]
        calls = {"dsine normals": (dsine, lambda p: p.predict_normals(rgb0),
                                   "normal"),
                 "metric3d depth": (m3d, lambda p: p.predict_depth(rgb0, fx),
                                    "depth"),
                 "metric3d normals": (m3d, lambda p: p.predict_normals(rgb0),
                                      "normal"),
                 "depth_anything inverse": (
                     da, lambda p: p.predict_inverse(rgb0), "depth")}
        cpu = {k: f(pair[1]) for k, (pair, f, _) in calls.items()}
        gaps, tf32 = {}, {}
        for k, (pair, f, kind) in calls.items():
            gaps[k] = _past_limit(f(pair[0]), cpu[k], kind)
        undo = _tf32_everywhere()
        try:
            for k, (pair, f, kind) in calls.items():
                tf32[k] = _past_limit(f(pair[0]), cpu[k], kind)
        finally:
            undo()
        for k in calls:
            log(f"priors view 0, card vs CPU, {k}: float32 max |d| "
                f"{gaps[k][0]:.3e}, past the limit {gaps[k][1]:.2e}; with "
                f"TF32 max |d| {tf32[k][0]:.3e}, past {tf32[k][1]:.2e}")

        # ms per frame (the predictor call, host pre/post included) and of
        # the net's forward alone at the input the predictor gives it, and
        # peak memory
        from fusionsense_tpu_torch.priors.depth_anything.predictor import (
            da_input_size,
        )
        from fusionsense_tpu_torch.priors.tf32 import full_float32

        g = torch.Generator(device=dev).manual_seed(0)
        img = lambda h, w: torch.randn((1, 3, h, w), device=dev,  # noqa: E731
                                       generator=g)
        K0 = torch.eye(3, device=dev)[None] * 500.0
        K0[:, 2, 2] = 1.0
        for name, (pair, fn, fwd) in {
                "dsine": (dsine, lambda p: p.predict_normals(rgb0),
                          (img(HEIGHT + (-HEIGHT) % 32, WIDTH + (-WIDTH) % 32),
                           K0)),
                "metric3d": (m3d, lambda p: p.predict_depth(rgb0, fx),
                             (img(*m3d[0].input_size),)),
                "depth_anything": (da, lambda p: p.predict_depth(rgb0, fx),
                                   (img(*da_input_size(HEIGHT, WIDTH)),))
        }.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = _event_ms(torch, lambda: fn(pair[0]))
            peak = torch.cuda.max_memory_allocated() / 1e9
            with torch.inference_mode(), full_float32():
                net_ms = cuda_ms(lambda: pair[0].net(*fwd), 3, 1)
            t0 = time.perf_counter()
            fn(pair[1])
            cpu_ms = 1e3 * (time.perf_counter() - t0)
            log(f"priors {name}: {ms:.2f} ms/frame on the card (event "
                f"timed, host pre/post included), the net's forward at "
                f"{tuple(fwd[0].shape[2:])} {net_ms:.2f} ms; {cpu_ms:.0f} ms "
                f"on the CPU; peak {peak:.3f} GB; {card}")
        bad = {k: v for k, v in gaps.items() if v[1] > PRIOR_FRAC}
        if bad:
            raise RuntimeError(f"priors: card and CPU disagree past the "
                               f"limits: {bad}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _camera_path_file(scene, path, picks=(0, 3, 6)):
    """A nerfstudio camera_path.json through capture frames `picks`, in the
    capture's own (raw, OpenGL) frame, each at the capture's vertical fov."""
    import numpy as np

    meta = json.loads((scene / "transforms.json").read_text())
    frames = []
    for i in picks:
        fr = meta["frames"][i % len(meta["frames"])]
        fy = fr.get("fl_y", meta.get("fl_y"))
        fov = math.degrees(2 * math.atan(HEIGHT / (2 * fy)))
        frames.append({"camera_to_world": np.asarray(
            fr["transform_matrix"], float).reshape(-1).tolist(), "fov": fov})
    path.write_text(json.dumps({"camera_path": frames}))
    return len(frames)


def _render_vs_plain(torch, argv, dev, png):
    """View 0 of an fs-render run through K1 or K3, against the same view
    rendered with the compositor's plain version (FC.flat_composite_fwd /
    C2.composite2_fwd swapped for their _plain twins) on the same card
    tensors: the same checkpoint, camera, projection and bins. rgb, normal
    and alpha are held at TOL_OUT; depth through the compositor's own
    channel, the accumulated depth (expected depth x max(alpha, 1e-3)),
    since the expected depth divides a float32 difference by alphas down to
    1e-3. fs-render's RGB PNG of view 0 must equal the kernel render
    quantised as fs-render writes it. Returns the max |d| by output and
    the PNG's largest level difference."""
    import numpy as np

    from fusionsense_tpu_torch.cli.render import build_parser, render_inputs
    from fusionsense_tpu_torch.data.image_io import read_image
    from fusionsense_tpu_torch.eval.evaluator import make_render_fn
    from fusionsense_tpu_torch.render import composite2 as C2
    from fusionsense_tpu_torch.render import flat_composite as FC
    from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
    from fusionsense_tpu_torch.train.checkpoint import checkpoint_sh_degree

    args = build_parser().parse_args(argv)
    g, cam = render_inputs(args, dev)
    cfg = RasterizeConfig(backend=args.backend,
                          sh_degree=checkpoint_sh_degree(g))
    kern = make_render_fn(cfg, cam)(g, 0)
    saved = FC.flat_composite_fwd, C2.composite2_fwd
    FC.flat_composite_fwd = FC.flat_composite_fwd_plain
    C2.composite2_fwd = C2.composite2_fwd_plain
    try:
        plain = make_render_fn(cfg, cam)(g, 0)
    finally:
        FC.flat_composite_fwd, C2.composite2_fwd = saved
    acc = lambda o: o.depth * torch.clamp_min(o.alpha, 1e-3)  # noqa: E731
    errs = {f: float((getattr(kern, f) - getattr(plain, f)).abs().max())
            for f in ("rgb", "normal", "alpha")}
    errs["depth (accumulated)"] = float((acc(kern) - acc(plain)).abs().max())
    errs["depth (expected)"] = float((kern.depth - plain.depth).abs().max())
    want = (np.clip(kern.rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    levels = int(np.abs(read_image(png).astype(np.int32) - want).max())
    return errs, levels


def render_path(torch, dev, counters, card, capture, ckpt):
    """fs-render in the port (phase 14) on the pipeline phase's last
    checkpoint: dataset mode (train split, with pose deltas written into a
    copy of the checkpoint) through K3, interpolate through the plain
    compositor, spiral through K1, camera-path through K3; the launches of
    each mode counted; every PNG read back; view 0 of each kernel mode held
    against the plain compositor on the same inputs (_render_vs_plain); the
    dataset renders masked by the capture's masks (eval.mask_render).
    Returns the K1 and K3 launches."""
    import shutil

    import numpy as np

    from fusionsense_tpu_torch.cli.render import main as fs_render
    from fusionsense_tpu_torch.data.dataparser import (
        DataParserConfig, parse_transforms,
    )
    from fusionsense_tpu_torch.data.image_io import read_image
    from fusionsense_tpu_torch.eval.mask_render import mask_images
    from fusionsense_tpu_torch.train.checkpoint import (
        load_checkpoint_full, save_checkpoint,
    )
    from fusionsense_tpu_torch.train.optim import init_adam

    out = SCRATCH / "render"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    scene = parse_transforms(DataParserConfig(data_dir=str(capture)),
                             device=dev)
    n_train = len(scene.train_idx)
    g, opt, stats, step, _, meta = load_checkpoint_full(ckpt, device=dev)
    gen = torch.Generator().manual_seed(0)
    deltas = (2e-3 * torch.randn((n_train, 6), generator=gen)).to(dev)
    ckpt_d = out / f"ckpt_{step}_deltas"
    save_checkpoint(ckpt_d, g, opt, stats, step, extra=meta,
                    cam_state=(deltas, init_adam({"deltas": deltas})))
    n_path = _camera_path_file(capture, out / "camera_path.json")
    runs = [("dataset", "pallas", [], n_train),
            ("interpolate", "jax", ["--n-frames", str(RENDER_FRAMES)],
             RENDER_FRAMES),
            ("spiral", "flat", ["--n-frames", str(RENDER_FRAMES)],
             RENDER_FRAMES),
            ("camera-path", "pallas", ["--camera-path",
                                       str(out / "camera_path.json")], n_path)]
    kernel = {"pallas": "composite2_fwd", "flat": "flat_composite_fwd"}
    total = {"composite2_fwd": 0, "flat_composite_fwd": 0}
    for mode, backend, extra, want in runs:
        d = out / mode
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = fs_render([mode, "--checkpoint", str(ckpt_d), "--data",
                       str(capture), "--output-dir", str(d), "--backend",
                       backend, *extra], device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
        pngs = {sub: sorted((d / sub).glob("*.png"))
                for sub in ("rgb", "depth", "normal")}
        shapes = {read_image(p).shape for ps in pngs.values() for p in ps}
        k = kernel.get(backend)
        log(f"fs-render {mode} --backend {backend}: {n} frames in {secs:.3f} "
            f"s ({1e3 * secs / max(n, 1):.1f} ms/frame), PNGs "
            f"{[len(v) for v in pngs.values()]} {sorted(shapes)}, "
            f"{k or 'no kernel'} launches {launches.get(k, 0)}; {card}")
        if not (n == want and all(len(v) == n for v in pngs.values())
                and shapes == {(HEIGHT, WIDTH, 3)}):
            raise RuntimeError(f"fs-render {mode}: {n} frames, PNGs "
                               f"{[len(v) for v in pngs.values()]} {shapes}")
        others = {key: v for key, v in launches.items() if key != k}
        if any(others.values()) or (k and launches[k] < n):
            raise RuntimeError(f"fs-render {mode} --backend {backend}: "
                               f"launches {launches}")
        if k:
            total[k] += launches[k]
            errs, levels = _render_vs_plain(
                torch, [mode, "--checkpoint", str(ckpt_d), "--data",
                        str(capture), "--backend", backend, *extra], dev,
                d / "rgb" / "00000.png")
            log(f"fs-render {mode} --backend {backend}, view 0 against the "
                f"plain compositor on the same inputs: max|d| "
                + ", ".join(f"{f} {v:.3e}" for f, v in errs.items())
                + f"; the RGB PNG against the kernel render: {levels} levels")
            held = {f: v for f, v in errs.items() if f != "depth (expected)"}
            if max(held.values()) > TOL_OUT or levels:
                raise RuntimeError(f"fs-render {mode} --backend {backend}: "
                                   f"view 0 disagrees with the plain "
                                   f"compositor or its PNG: {errs}, {levels}")

    # the dataset renders, masked by the capture's masks of the same views
    masks = out / "masks"
    masks.mkdir()
    for i, j in enumerate(scene.train_idx):
        shutil.copy(scene.mask_paths[j], masks / f"{i:05d}.png")
    n_masked = mask_images(out / "dataset" / "rgb", masks, out / "masked")
    m0 = read_image(masks / "00000.png")
    m0 = (m0[..., 0] if m0.ndim == 3 else m0) <= 127
    bg = read_image(out / "masked" / "00000.png")[m0]
    log(f"mask_images: {n_masked} dataset renders masked; view 0's "
        f"background {m0.mean():.3f} of the pixels, all white: "
        f"{bool((bg == 255).all())}")
    if n_masked != n_train or not (bg == 255).all():
        raise RuntimeError("mask_images: renders not masked")
    return total


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from fusionsense_tpu_torch.kernels.build import SOURCES, build_all
        from fusionsense_tpu_torch.render import composite2 as C2
        from fusionsense_tpu_torch.render import flat_composite as FC
        from fusionsense_tpu_torch.train.trainer import Trainer
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log("installations: " + ", ".join(
        f"{k} {'imports' if v else 'missing'}"
        for k, v in installations().items()))

    # 1. device and build
    card = nvidia_smi("name,power.limit")
    log(f"card: {nvidia_smi('name,power.limit,clocks.sm')}")
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(SOURCES)}")
    for b in built:
        for line in b.log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"  ptxas {b.name}: {line.strip()}")

    # 2. scene
    t0 = time.perf_counter()
    cams, data, init, cfg, gt_budget = build_scene(torch, dev)
    init_dense = init.replace(**{k: v.clone() for k, v in init.fields().items()})
    init_fs = init.replace(**{k: v.clone() for k, v in init.fields().items()})
    init_jax = init.replace(**{k: v.clone() for k, v in init.fields().items()})
    init_fused = [init.replace(**{k: v.clone() for k, v in init.fields().items()})
                  for _ in range(2)]
    tr = Trainer(cfg, cams, data, init, device=dev)
    torch.cuda.synchronize()
    log(f"scene: {time.perf_counter() - t0:.1f} s (GT budget {gt_budget}); "
        f"capacity {tr.gaussians.capacity}, render_n {tr.render_n}")

    # 3. K1/K2 against their plain versions, at the initial shapes
    errs0, _ = check_kernels(torch, tr, tr.tile_capacity, tr.cover_tiles,
                             timed=False)

    # 4. the flat path
    flat_names = ("flat_composite_fwd", "flat_composite_bwd")
    launches, ms_step, timed_shape = train_path(torch, tr, "flat", (FC, C2),
                                                flat_names)

    # 5. K1/K2 against their plain versions at the timed steps' shape
    errs1, kernels = check_kernels(torch, tr, *timed_shape, timed=True)
    for k, key in zip(kernels, ("fwd", "bwd")):
        k["launches"] = launches[f"flat_composite_{key}"]
        k["max_abs_err"] = max(errs0[key], errs1[key])

    # 6. where the flat step's device time goes
    profile_steps(torch, tr, "flat", ms_step)

    # 7. the dense path: K3/K4 at the initial shape, 60 steps, K3/K4 at the
    # timed shape, a profile
    tr_d = Trainer(dense_config(), cams, data, init_dense, device=dev)
    log(f"dense: capacity {tr_d.gaussians.capacity}, render_n {tr_d.render_n}, "
        f"tile_capacity {tr_d.tile_capacity}, cover {tr_d.cover_tiles}")
    errs0, _ = check_dense_kernels(torch, tr_d, tr_d.tile_capacity,
                                   tr_d.cover_tiles, timed=False)
    dense_names = ("composite2_fwd", "composite2_bwd")
    launches, ms_step, timed_shape = train_path(torch, tr_d, "dense",
                                                (FC, C2), dense_names)
    errs1, dense_kernels = check_dense_kernels(torch, tr_d, *timed_shape,
                                               timed=True)
    for k, key in zip(dense_kernels, ("fwd", "bwd")):
        k["launches"] = launches[f"composite2_{key}"]
        k["max_abs_err"] = max(errs0[key], errs1[key])
    profile_steps(torch, tr_d, "dense", ms_step)
    del tr_d

    # 8. the fusionsense path: the whole schedule, K3/K4 at the grown K
    fs_kernels, fs_launches, tr_fs = fusionsense_path(torch, cams, data,
                                                      init_fs, dev, (FC, C2))

    # 9. the mesh phase: five methods on the fusionsense model (K3), tsdf
    # on the flat model (K1)
    mesh_launches = mesh_path(torch, tr_fs, tr, cams, (FC, C2), card)
    del tr, tr_fs

    # 10. fs-train's default backend, jax (the plain compositor)
    jax_backend_path(torch, cams, data, init_jax, dev, (FC, C2), card)

    # 11. fs-train end to end from a capture on disk, through K3/K4, with
    # its default meshes, then fs-mesh and fs-eval
    pipe_launches, pipe_errs = pipeline_path(torch, dev, (FC, C2), card)
    # 12. fused refine intervals as CUDA graph replays, flat and dense
    fused_flat = fused_path(torch, "flat", cfg, cams, data, init_fused[0],
                            dev, (FC, C2), flat_names)
    fused_dense = fused_path(torch, "dense", dense_config(), cams, data,
                             init_fused[1], dev, (FC, C2), dense_names)
    for k, key in zip(kernels, ("fwd", "bwd")):
        k["launches"] += fused_flat[f"flat_composite_{key}"]
    kernels[0]["launches"] += mesh_launches["flat_composite_fwd"]
    for k, d, key in zip(fs_kernels, dense_kernels, ("fwd", "bwd")):
        k["launches"] = (d["launches"] + fs_launches[f"composite2_{key}"]
                         + pipe_launches[f"composite2_{key}"]
                         + fused_dense[f"composite2_{key}"])
        k["max_abs_err"] = max(k["max_abs_err"], d["max_abs_err"],
                               pipe_errs[key])
    fs_kernels[0]["launches"] += (mesh_launches["composite2_fwd"]
                                  + pipe_launches["cli_composite2_fwd"])

    # 13. the monocular priors on the pipeline's capture
    priors_path(torch, dev, card, SCRATCH / "blob")
    # 14. fs-render on the pipeline's last checkpoint, K1 and K3 counted
    render_launches = render_path(
        torch, dev, (FC, C2), card, SCRATCH / "blob",
        SCRATCH / "pipeline" / "dn_splatter" / f"ckpt_{PIPE_ITERS}")
    kernels[0]["launches"] += render_launches["flat_composite_fwd"]
    fs_kernels[0]["launches"] += render_launches["composite2_fwd"]

    # 15. results
    print(json.dumps({"kernels": kernels + fs_kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
