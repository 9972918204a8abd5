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
    then the preprocess kernel pair against its plain version on the
    first PRE_N Gaussians and view 0 (check_preprocess: every float output
    and input gradient, radius and valid equal off the rows at a rounding
    tie, and d viewmat from a second backward), each timed with the plain
    version beside its byte bound; then the SSIM kernel pair against its
    plain version at 640x480x3 (check_ssim: view 0's render against its
    target, both held to a float64 evaluation; equal images give 1; two
    calls equal to the bit), each timed beside its byte bound, the plain
    version and, as library_ms, the same forward through F.conv2d;
 4. the flat path: Trainer.run for 60 steps (the bin cache is refreshed and
    reused), with every launch counter zeroed just before and read after
    (the preprocess pair's too: at least one forward and one backward a
    step, no plain call; the SSIM pair's: one forward and one backward a
    step, no plain call);
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
    tsdf sugar-coarse), then a second main resumed from ckpt_600 to step
    699 (an empty --mesh). Seconds per stage (the mesh stage's too), the
    prior and seed counts, ms/step, peak memory, the K3/K4 launches (their
    plain twins never), the metrics.json means and the logged PSNR, which
    must rise; every artifact read back through the port's own readers; the
    resumed run must enter at step 600 with the patch frozen, and its
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
15. fs-touch (touch mode) on phase 11's TSDF mesh and the resumed run's
    high-grad cloud: the full-width GLIP detector (Swin-L, BERT-base, the
    8-tower VLDyHead) from a seeded random state dict written as the
    published .pth wraps it and loaded back through load_glip_checkpoint,
    on the 10 z-buffer views at 800x800, superpoints by the cut-pursuit
    library built from native/cutpursuit.cpp, the vote and the proposals;
    the proposals file read back (TOUCH_QUOTA points, or as many as the
    cloud has), no kernel launched; each stage's ms, the peak memory and
    the seconds; view 0's GLIP outputs card against CPU at min_size 320;
    the GLIP forward's stages timed at 800x800;
16. the omnidata normal prior on phase 11's capture (a copy): the
    DPT-Hybrid net (vitb_rn50_384) at its published width from a seeded
    random state dict written as the published .ckpt wraps it, loaded by
    default_normal_model(model_type="omnidata", resolution="hd");
    generate_priors with its HD normals (7 patches a 640x480 frame) over
    every frame, each stored normal of unit length within 1e-3; view 0,
    card against CPU at the priors' limits: the low path's normals and the
    HD path's 7 patches (the merged HD map's gap reported beside them), with
    TF32's reading; ms per 384x384 forward and per predictor call, peak
    memory; no kernel of K1-K4;
17. the live viewer: fs-train --viewer --viewer-port 0 resumed from phase
    11's last checkpoint for 20 steps through K3/K4 (counted), its
    server's /state and /splats.bin against the trainer (the step, the
    alive count, pack_state's bytes); the time to pack and serve a
    snapshot at that population; then fs-viewer on the checkpoint and on
    its splat PLY, each in a subprocess: the URL line, the page (the
    package's viewer.html), /state and /splats.bin;
18. the NeRF baseline on phase 11's capture: NerfConfig()'s published
    defaults (12 levels, a 2^17 table, 64 samples, 4,096 rays a step) with
    the depth loss on, 200 Adam steps whose PSNR must rise (the last 20
    against the first 20); one step and one 640x480 render_image timed with
    CUDA events, peak memory; no kernel of K1-K4;
19. multi-device training (parallel/): K1/K2 on view 0's flat table of
    the initial state split into 2 and 4 tile blocks at tile_lo = me *
    T_loc, and K3/K4 on its dense table split into row blocks at their
    global tile ids, each against its plain version and the blocks'
    outputs concatenated against the unsharded kernel's; then 8 ranks
    spawned on the one card (gloo, the backend rule of parallel/mesh.py),
    a data=2 x tile=2 x gauss=2 mesh (MULTICHIP_r05.json's shape): one
    sharded step against the single-device batch-mean step at
    test_parallel.py's depth-slice tolerances and ZeRO-1 against the
    replicated step at its ZeRO-1 ones; the step's collectives timed
    alone; ShardedTrainer with ZeRO-1 for 60 steps of the flat bench
    configuration and of dn_splatter with pallas, refines at 30 and 60:
    view-0 PSNR rising, the population changed, every rank's state
    bit-equal (digests gathered to rank 0), K1-K4 launched on every rank
    every step and no plain twin, ms/step (8 ranks sharing one card, not
    a scaling number); rank 0's checkpoint restored into a single-device
    Trainer for 10 steps; fs-train --device-mesh through torchrun (8
    ranks, flat, 200 steps, an empty --mesh) on a copy of phase 11's
    capture, rank 0's artifacts read back and its logged PSNR rising;
20. long-run parity (tests/torch_long_parity.py's scene, built with the
    port: bench.py's cut to 160x120, 6,000 GT / 3,000 init points, tile
    16, capacity 2^14): run_fused of one 100-step interval + sync_policies
    to step 4,000 for seeds 0-4 through CUDA graphs of K1/K2's step; at
    every 100-step boundary the seeds' mean alive count and 9-view mean
    PSNR inside the JAX package's float32 seed envelope read from
    tests/torch_long_parity_jax.json, one line per boundary; K1/K2 at
    every step, no plain twin;
21. a {"kernels": [...]} line for all four kernels, the preprocess
    pair and the SSIM pair (their launches those of the flat path's 60
    steps; K3/K4 timed at the
    fusionsense path's post-refine shape; launches those of every path
    that runs the kernel, graph replays, the mesh renders, fs-render's
    renders, the viewer phase's steps, the sharded ranks' steps and the
    long-parity seeds' included; errors the largest of every check; the
    blend_bf16 branch's
    times and error beside the float32 ones), the card line, and last the
    result line.
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
# the preprocess kernel pair (render/preprocess.py): the benchmark cell's
# render prefix at its warm boundary, and tests/test_torch_preprocess.py's
# limits (here over each array's largest |plain|), plus PRE_ULPS times what
# the plain version moves when its inputs move by one ulp
PRE_N = 24_576
TOL_PRE_FWD, TOL_PRE_GRAD = 1e-5, 5e-5
PRE_ULPS = 4       # times the plain version's own one-ulp sensitivity
# radius and valid must be equal but on a row whose pre-ceil radius, or a
# screen bound's distance to its position, lies this close (relatively) to
# the value where the two sides may round across it (as the tests' TIE_REL)
PRE_TIE = 1e-5
# the SSIM kernel pair (train/losses.py) against its plain version, each
# held to a float64 evaluation as tests/test_torch_ssim.py holds them: the
# kernels' gap at most SSIM_GAP times the plain float32 version's, or
# SSIM_ATOL on the mean and SSIM_GRAD_RTOL of the gradient's largest |value|
SSIM_GAP, SSIM_ATOL, SSIM_GRAD_RTOL = 4.0, 1e-6, 1e-6
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
# A stage's blend (acc, sacc of fwd_blocks and fwd_chunks) is held to one
# flip's size at its own values: a w below 1 that lands on the neighbouring
# bf16 value moves the blend by at most 2^-8 times the channel value it
# weighs, so each element may differ by BF16_ULP times the largest |channel|
# that its block or chunk blends in that channel, or by BF16_ULP where
# that is below 1 (one bf16 ulp of a unit channel, as above).
# K3's fwd_chunks exp(delta) is held to a float64 evaluation of the same
# chunks (each alpha in float64 where the plain twin's is nonzero): the
# kernel's max|d| to it at most EXP_DELTA_GAP times the twin's own, or
# TOL_ALPHA where that is larger. Both sum up to B float32 log(1 - alpha)
# terms front to back; the kernel rounds each term in its own order.
EXP_DELTA_GAP = 4.0
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
PIPE_TOUCH_AT, PIPE_SAVE = 150, 300
# the second run resumes from the last checkpoint (step PIPE_ITERS) for 99
# steps, the most before the refine at 700 resets the stats its high-grad
# export reads: DBSCAN's min_samples 15 needs the settled population. From
# ckpt_300 after 60 steps the densest neighbourhood held 13-17 points (0-2
# core points), and the one cluster came and went with float rounding;
# from ckpt_600 after 99 steps 17-57 core points in 1-7 clusters, with the
# seed cloud as written and moved one ulp, before and after the preprocess
# kernels
PIPE_RESUME_ITERS = 699
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
# the touch phase: fs-touch on the pipeline phase's TSDF mesh and the
# resumed run's high-grad cloud, with the full-width GLIP detector on a
# seeded random state dict (detection.convert.random_state_dict) and the
# toy tokenizer of the parts' caption; the score threshold is low enough
# for the random net's boxes to reach the vote. View 0's GLIP outputs at
# min_size TOUCH_CPU_SIZE, card against CPU: an element is past the limit
# where it moves by more than GLIP_REL of its array's largest |value|; at
# most GLIP_FRAC of an array's elements may be. Set from the first reading
# on the H100 (PERF.md): at most 3.4e-4 of the scale, with 22-33% of the
# elements past 1e-4.
TOUCH_SEED = 0
TOUCH_PARTS = ("handle", "body", "base")
TOUCH_QUOTA, TOUCH_THRESHOLD, TOUCH_CPU_SIZE = 10, 0.02, 320
GLIP_REL, GLIP_FRAC = 1e-3, 1e-3
# the omnidata phase: the DPT-Hybrid normal net at its published width
# (vitb_rn50_384) with seeded random weights at a deep net's scale; its
# head's last conv scaled by OMNI_HEAD_SCALE and its bias lifted by
# OMNI_BIAS_LIFT (x, y, forward), so the encoded normals lie inside (0, 1)
# and decode to vectors near unit length, mostly facing the camera, as a
# trained net's do (unscaled, the random head's outputs reach ~270 and 93%
# of them clamp; centred on 0.5 they decode to near-zero vectors, whose
# renormalisation magnifies float32 noise; PERF.md); held card against CPU
# at the priors' limits above
OMNI_SEED, OMNI_HEAD_SCALE, OMNI_BIAS_LIFT = 3, 0.01, (0.5, 0.5, 1.0)
# the viewer phase: fs-train --viewer resumed from the pipeline's last
# checkpoint for VIEWER_STEPS steps, then fs-viewer in a subprocess, whose
# URL line must come within VIEWER_WAIT seconds; the viewer's default cap
VIEWER_STEPS, VIEWER_WAIT, VIEWER_MAX = 20, 180, 400_000
# the NeRF phase: NerfConfig()'s published defaults with the depth loss on,
# NERF_STEPS steps in chunks of NERF_CHUNK, PSNR of the first and the last
# NERF_WINDOW steps
NERF_SEED, NERF_DEPTH_LAMBDA = 0, 0.1
NERF_STEPS, NERF_CHUNK, NERF_WINDOW = 200, 20, 20
# the sharded phase: MULTICHIP_r05.json's mesh shape (data=2 x tile=2 x
# gauss=2, ZeRO-1) in SHARD_RANKS processes sharing the one card (gloo:
# NCCL takes one rank per card). K1/K2's tile blocks at tile_lo and K3/K4's
# at offset tile ids for each shard count of SHARD_SPLITS; one sharded step
# against the single-device batch-mean step at test_parallel.py's
# depth-slice tolerances (ZeRO-1 against the replicated step at its ZeRO-1
# ones), at a pair budget neither side overflows. Adam's first step moves
# each parameter by lr times the gradient's sign, so the means check holds
# only signs (any two first steps are within 2 lr = 3.2e-4 of each other);
# the first moments (0.1 x the reduced gradient) carry its scale and are
# also held relative to their largest entry, at TOL_SHARD_SCALE (ZeRO-1 at
# TOL_ZERO1_SCALE): a lost 1 / (n_tile n_gauss) or a gather whose backward
# does not sum is off by a factor, far past either. SHARD_STEPS steps of the
# flat and of the dense trainer with a refine every SHARD_ADC, logged every
# SHARD_LOG; fs-train --device-mesh through torchrun for SHARD_CLI_ITERS
SHARD_AXES = dict(data=2, tile=2, gauss=2)
SHARD_RANKS, SHARD_SPLITS, SHARD_TILE_CAPACITY = 8, (2, 4), 4096
SHARD_STEPS, SHARD_LOG, SHARD_RESUME_STEPS = 60, 10, 10
SHARD_ADC = dict(warmup=30, refine_every=30)
TOL_SHARD, TOL_SHARD_M = dict(atol=4e-4, rtol=1e-3), dict(atol=4e-4, rtol=2e-3)
TOL_ZERO1 = dict(atol=3e-5, rtol=1e-3)
TOL_SHARD_SCALE, TOL_ZERO1_SCALE = 1e-2, 1e-3
SHARD_CLI_ITERS, SHARD_CLI_WARMUP, SHARD_WAIT = 200, 100, 900
# the long-parity phase: tests/torch_long_parity.py's scene, built with the
# port alone (bench.py's cut to LONG_W x LONG_H, focal 550 * LONG_W / 640,
# LONG_GT / LONG_INIT points, tile 16, capacity 2^14; ADCConfig(), bin
# refresh 18, flat), trained by run_fused of one 100-step interval and
# sync_policies to LONG_STEPS for each of LONG_SEEDS; at every boundary the
# seeds' mean alive count and 9-view mean PSNR lie within the JAX seeds'
# envelope read from LONG_REF (float32 CPU runs of the JAX package): their
# mean +- max(2 x their sample standard deviation, LONG_ALIVE_FLOOR of the
# alive mean / LONG_PSNR_FLOOR dB)
LONG_W, LONG_H, LONG_GT, LONG_INIT = 160, 120, 6_000, 3_000
LONG_TILE, LONG_CAPACITY, LONG_STEPS, LONG_EVERY = 16, 1 << 14, 4000, 100
LONG_SEEDS = range(5)
LONG_ALIVE_FLOOR, LONG_PSNR_FLOOR = 0.02, 0.1
LONG_REF = (Path(__file__).resolve().parent / "tests"
            / "torch_long_parity_jax.json")


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


def build_scene(torch, dev, width=WIDTH, height=HEIGHT, n_gt=N_GT,
                n_init=N_INIT, capacity=CAPACITY, tile=32, focal=FOCAL):
    """bench.py's scene and trainer configuration, from the port's code
    (at the bench's size unless cut by the arguments)."""
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

    rcfg = RasterizeConfig(tile_size=tile, tile_capacity=512,
                           max_tiles_per_gaussian=9, tile_chunk=100,
                           sh_degree=3, backend="flat")
    cams = ring_cameras(n_views=N_VIEWS, width=width, height_px=height,
                        focal=focal, device=dev)
    pts, rgb, normals = sphere_points(n=n_gt, radius=0.5, device=dev)
    gt = init_from_points(pts, rgb, capacity=capacity, sh_degree=3,
                          seed_normals=normals, init_opacity=0.95)
    # the GT model's dead slots have opacity 0: render its alive prefix
    m, q, s, o, c = (x[:n_gt] for x in activated(gt))
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
    pts2, rgb2, n2 = sphere_points(n=n_init, radius=0.5, seed=1, device=dev)
    rng = np.random.RandomState(0)
    noise = 0.02 * rng.randn(*pts2.shape).astype(np.float32)
    init = init_from_points(pts2 + torch.as_tensor(noise, device=dev),
                            torch.full_like(rgb2, 0.5), capacity=capacity,
                            sh_degree=3, seed_normals=n2)
    cfg = ExperimentConfig(
        model=ModelConfig(sh_degree=3, rasterize=rcfg, capacity=capacity,
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


def check_bf16(torch, name, got, plain, f32, limit, scale="abs",
               flip=None):
    """A product of the blend_bf16 branch: the bf16 kernel's `got` against
    the bf16 twin's `plain` on the same inputs, beside `f32`, the float32
    kernel's on those inputs. |d| is taken absolutely (`scale` "abs"),
    over max|plain| ("max") or over each column's max|plain| ("columns",
    the last dimension). At most BF16_FLIP_FRAC of the elements may exceed
    the float32 `limit`, none may exceed BF16_ULP (or, for "abs", its own
    `flip`, a tensor of got's shape: the size of one flip at its values),
    and f32's mean |d| must be at least BF16_SEEN times got's (in each
    column, for "columns"). Returns the largest absolute difference."""
    width = got.shape[-1] if scale == "columns" else 1
    if flip is None:
        flip = torch.full_like(got, BF16_ULP)
    got, plain, f32, flip = (x.reshape(-1, width)
                             for x in (got, plain, f32, flip))
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
    over = d / flip
    at = int(over.argmax()) if d.numel() else 0
    flips = float(over.max()) if d.numel() else 0.0
    mean, mean32 = d.mean(dim=0), d32.mean(dim=0)
    seen = float((mean32 / mean.clamp_min(1e-30)).min())
    log(f"{name} bf16 vs twin: beyond the float32 limit {limit:.0e}: "
        f"{frac:.3e} of {d.numel()} (limit {BF16_FLIP_FRAC:.0e}); max|d| "
        f"{worst:.3e}, over its flip size {flips:.3f} (limit 1; the worst "
        f"{float(d.flatten()[at]) if d.numel() else 0.0:.3e} against "
        f"{float(flip.flatten()[at]) if d.numel() else BF16_ULP:.3e}); "
        f"mean|d| {float(mean.max()):.3e}"
        f", float32 kernel's {float(mean32.min()):.3e}: {seen:.3g}x "
        f"(limit {BF16_SEEN:.0f}x)" + (" in the worst column"
                                      if scale == "columns" else ""))
    if not (frac <= BF16_FLIP_FRAC and flips <= 1.0
            and seen >= BF16_SEEN):
        raise RuntimeError(f"{name}: the bf16 branch disagrees with its "
                           f"plain twin or does not round")
    return float((got - plain).abs().max()) if got.numel() else 0.0


def flip_sizes(torch, rows, shape):
    """The size of one bf16 flip in each element of a blend of `shape`
    (..., C, P), from its blocks' or chunks' table rows (..., B, 8 + C):
    BF16_ULP times the largest |channel| a block blends in that channel,
    or BF16_ULP where that is below 1."""
    ch = rows[..., 8:].abs().amax(dim=-2).clamp_min(1.0)
    return (BF16_ULP * ch)[..., None].expand(shape)


def chunk_delta64(torch, table, counts, tile_ids, tiles_x, tile_size, B):
    """fwd_chunks_plain's delta in float64: each chunk's sum of
    log(1 - alpha) front to back, alpha formed in float64 from the same
    table where the float32 twin's alpha is nonzero (the same rows pass
    the 1/255 cut) and 0 elsewhere. Chunks past ceil(count / B) are 0."""
    from fusionsense_tpu_torch.render import composite2 as C2
    from fusionsense_tpu_torch.render.flat_composite import (
        LOG_ALPHA_MAX, _alpha_of_rows, _pixel_xy,
    )

    T, K, _ = table.shape
    P, nc = tile_size * tile_size, K // B
    delta = torch.zeros((T, nc, P), dtype=torch.float64, device=table.device)
    n = C2.n_chunks(counts, B, nc)
    px_all, py_all = _pixel_xy(tile_ids.long(), tiles_x, tile_size, P)
    for c in range(nc):
        tl = torch.nonzero(c < n).squeeze(1)
        if tl.numel() == 0:
            break
        rows = table[tl, c * B:(c + 1) * B]
        px, py = px_all[tl], py_all[tl]
        alpha32, _, _ = _alpha_of_rows(rows, px, py)
        r = rows.double()
        dx, dy = px.double() - r[..., 0:1], py.double() - r[..., 1:2]
        power = -(0.5 * r[..., 2:3] * dx * dx + r[..., 3:4] * dx * dy
                  + 0.5 * r[..., 4:5] * dy * dy) + r[..., 5:6]
        alpha = torch.exp(torch.clamp_max(power, LOG_ALPHA_MAX))
        alpha = torch.where(alpha32 > 0, alpha, torch.zeros_like(alpha))
        delta[tl, c] = torch.log1p(-alpha).sum(dim=1)
    return delta


def exp_delta_errs(torch, got, plain, exact):
    """K3's fwd_chunks exp(delta), the kernel's `got` and its twin's
    `plain`, against the float64 evaluation `exact`: {what: (max|d|,
    limit or None)}; the kernel's limit is EXP_DELTA_GAP times the twin's
    max|d|, or TOL_ALPHA where that is larger."""
    ex = torch.exp(exact)
    k_gap = max_err(torch.exp(got.double()), ex)
    p_gap = max_err(torch.exp(plain.double()), ex)
    return {"exp(delta) vs the twin": (max_err(torch.exp(got),
                                               torch.exp(plain)), None),
            "exp(delta) vs float64": (k_gap, max(TOL_ALPHA,
                                                 EXP_DELTA_GAP * p_gap)),
            "the twin's": (p_gap, None)}


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
        flip = flip_sizes(torch, table.reshape(-1, geo[-1], table.shape[-1]),
                          k[1].shape)
        return {w: (check_bf16(torch, f"K1 fwd_blocks {w}", k[i], p[i],
                               f32["acc"], TOL_OUT, flip=flip), None)
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
    T, K, W = table.shape
    nc = K // B
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
    delta64 = chunk_delta64(torch, table, counts, tile_ids, *geo)[done]
    e = max_err
    differ = lambda a, b: int((a != b).sum())  # noqa: E731

    def acc_errs(k, p):
        if not bf16:
            return {"acc": (e(k[1][done], p[1][done]), TOL_OUT)}
        flip = flip_sizes(torch, table.reshape(T, nc, B, W), k[1].shape)
        return {w: (check_bf16(torch, f"K3 fwd_chunks {w}", k[i][done],
                               p[i][done], f32["acc"][done], TOL_OUT,
                               flip=flip[done]), None)
                for w, i in (("acc", 1), ("sacc", 2))}

    stages = [
        ("fwd_chunks", (table, counts, tile_ids, *geo_b),
         lambda k, p: {**exp_delta_errs(torch, k[0][done], p[0][done],
                                        delta64),
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
        gaussian_flat_normals, prepare, tile_table,
    )
    from fusionsense_tpu_torch.train.trainer import patched_cfg

    cfg = patched_cfg(tr.cfg, tile_capacity, cover_tiles)
    rc = dataclasses.replace(cfg.model.rasterize, backend="flat")
    cam = tr.camera.index(0)
    n = tr.render_n
    with torch.no_grad():
        means, quats, scales, op, colors = (x[:n] for x in activated(tr.gaussians))
        ft = tile_table(prepare(means, quats, scales, op, colors, cam, rc,
                                gaussian_flat_normals(quats, scales, means,
                                                      cam.origin), None),
                        cam, rc)
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
        gaussian_flat_normals, prepare, tile_table,
    )
    from fusionsense_tpu_torch.train.trainer import patched_cfg

    cfg = patched_cfg(tr.cfg, tile_capacity, cover_tiles)
    rc = dataclasses.replace(cfg.model.rasterize, backend="pallas")
    cam = tr.camera.index(0)
    n = tr.render_n
    with torch.no_grad():
        means, quats, scales, op, colors = (x[:n] for x in activated(tr.gaussians))
        dt = tile_table(prepare(means, quats, scales, op, colors, cam, rc,
                                gaussian_flat_normals(quats, scales, means,
                                                      cam.origin), None),
                        cam, rc)
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


def check_preprocess(torch, tr):
    """The preprocess kernel pair against its plain version on the
    trainer's first PRE_N Gaussians (scales made anisotropic) and view 0,
    with cotangents on what the
    tables read (mean2d + tap, conic, op, channels); then each kernel and
    the plain version's forward and backward timed with CUDA events, beside
    the kernels' byte bounds. Returns the {"kernels"} entries."""
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render import preprocess as PP
    from fusionsense_tpu_torch.render.rasterize import gaussian_flat_normals

    cfg = tr.cfg.model.rasterize
    cam = tr.camera.index(0)
    dev = cam.device
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        ins = [x[:PRE_N].contiguous() for x in activated(tr.gaussians)]
        # the seed cloud's scales are isotropic, which leaves a quaternion
        # no gradient but rounding: make them anisotropic
        ins[2] = ins[2] * torch.exp(0.5 * torch.randn(
            ins[2].shape, generator=gen, device=dev))
        ins.append(gaussian_flat_normals(*ins[1:3], ins[0], cam.origin))
        ins.append(torch.zeros((PRE_N, 2), device=dev))
    m, q, s, o, c, nrm, tap = ins
    cam_t = (cam.viewmat.contiguous(), cam.fx, cam.fy, cam.cx, cam.cy)
    ints, floats = PP._geometry(cfg, cam.width, cam.height)
    g = {k: torch.randn(shape, generator=gen, device=dev) for k, shape in (
        ("mean2d_t", (PRE_N, 2)), ("conic", (PRE_N, 3)), ("op", (PRE_N,)),
        ("chan", (PRE_N, 7)))}
    cots = (None, g["mean2d_t"], None, g["conic"], None, g["op"], g["chan"])
    needs = (True,) * 6 + (False,)   # as the cell's steps: no d viewmat

    def fwd():
        return PP.preprocess_fwd_cuda(m, q, s, o, c, nrm, tap, cam_t, ints,
                                      floats)

    def bwd():
        return PP.preprocess_bwd_cuda(m, q, s, o, c, cam_t, ints, floats,
                                      cots, needs)

    leaves = [x.clone().requires_grad_(True) for x in ins]

    def plain_fwd():
        return PP.preprocess_plain(*leaves[:5], cam, cfg, leaves[5],
                                   leaves[6])

    pre = plain_fwd()
    outs = (pre.mean2d, pre.proj.conic, pre.op, pre.channels)
    gs = (g["mean2d_t"], g["conic"], g["op"], g["chan"])

    def plain_bwd():
        return torch.autograd.grad(outs, leaves[:6], gs, retain_graph=True)

    def rel(got, want):
        # over the array's largest |plain|, not each column's: a column
        # whose terms cancel holds nothing but rounding
        if got.dtype == torch.bool:
            return float((got != want).float().mean())
        return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))

    def plain_at(xs):
        """The plain version's outputs, and the gradients of the inputs and
        of the viewmat, at inputs xs."""
        lv = [x.detach().clone().requires_grad_(True) for x in xs]
        vm = cam.viewmat.detach().clone().requires_grad_(True)
        p = PP.preprocess_plain(*lv[:5], cam.replace(viewmat=vm), cfg, lv[5],
                                lv[6])
        grads = torch.autograd.grad(
            (p.mean2d, p.proj.conic, p.op, p.channels), lv[:6] + [vm], gs)
        return (p.proj.mean2d, p.mean2d, p.proj.depth, p.proj.conic,
                p.proj.radius, p.proj.valid, p.proj.compensation, p.op,
                p.channels), grads

    k_out = fwd()
    k_grad = bwd()
    # the camera-optimisation branch (bwd_kernel<true> and its fixed-order
    # reduction): every gradient again, d viewmat with them
    k_grad_cam = PP.preprocess_bwd_cuda(m, q, s, o, c, cam_t, ints, floats,
                                        cots, (True,) * 7)
    torch.cuda.synchronize()
    p_out, p_grad = plain_at(ins)
    # the plain version's own float32 sensitivity: its change when every
    # input moves by one ulp at random (a large Gaussian's determinant
    # cancels hundreds of ulps, in the kernels and in the plain version)
    q_out, q_grad = plain_at([x * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, x.shape, generator=gen, device=dev)) for x in ins])
    names = ("mean2d", "mean2d_t", "depth", "conic", "radius", "valid",
             "comp", "op", "chan")
    gnames = ("means", "quats", "scales", "opacities", "colors", "normals")
    float_names = [n for n in names if n not in ("radius", "valid")]
    k_fwd, p_fwd, q_fwd = (dict(zip(names, x)) for x in (k_out, p_out, q_out))
    fwd_err = {n: rel(k_fwd[n], p_fwd[n].detach()) for n in float_names}
    fwd_ulp = {n: rel(q_fwd[n].detach(), p_fwd[n].detach())
               for n in float_names}
    grad_err = {n: rel(a, b) for n, a, b in zip(gnames, k_grad, p_grad)}
    grad_err.update({f"{n} (cam)": rel(a, b) for n, a, b in zip(
        gnames + ("viewmat",), k_grad_cam, p_grad)})
    grad_ulp = {n: rel(a, b) for n, a, b in zip(gnames + ("viewmat",),
                                                 q_grad, p_grad)}
    grad_ulp.update({f"{n} (cam)": grad_ulp[n] for n in grad_ulp})
    # radius and valid equal except on a row at a rounding tie
    ties = preprocess_ties(torch, p_fwd, cam.width, cam.height)
    keep = ~ties
    flag_err = {n: int((k_fwd[n][keep] != p_fwd[n][keep]).sum())
                for n in ("radius", "valid")}
    log(f"preprocess at N = {PRE_N} (view 0, SH {cfg.sh_degree}): forward "
        f"max |d| / max |plain| {fwd_err}; radius, valid: rows that differ "
        f"{flag_err} off {int(ties.sum())} rows at a tie (on them "
        f"{int((k_fwd['radius'][ties] != p_fwd['radius'][ties]).sum())}, "
        f"{int((k_fwd['valid'][ties] != p_fwd['valid'][ties]).sum())}); "
        f"gradients {grad_err} ((cam): the backward with d viewmat); the "
        f"plain version moved by one input ulp: forward {fwd_ulp}, "
        f"gradients {grad_ulp}")
    bad = [n for n in float_names
           if fwd_err[n] > TOL_PRE_FWD + PRE_ULPS * fwd_ulp[n]]
    bad += [n for n in grad_err
            if grad_err[n] > TOL_PRE_GRAD + PRE_ULPS * grad_ulp[n]]
    bad += [n for n, v in flag_err.items() if v]
    if bad:
        raise RuntimeError(f"preprocess: the kernels disagree with the plain "
                           f"version in {bad}")
    floats_err = [fwd_err[n] for n in float_names]
    K = c.shape[1]
    fwd_bytes = PRE_N * (4 * (3 + 4 + 3 + 1 + 3 * K + 3 + 2)
                         + 4 * (2 + 2 + 1 + 3 + 1 + 1 + 1 + 7) + 1)
    bwd_bytes = PRE_N * (4 * (3 + 4 + 3 + 1 + 3 * K) + 4 * (2 + 3 + 1 + 7)
                         + 4 * (3 + 4 + 3 + 1 + 3 * K + 3))
    entries = timed_entries("fusionsense_tpu_torch/csrc/preprocess.cu", [
        ("preprocess_fwd", "none (the JAX package leaves it to XLA)", fwd,
         plain_fwd, fwd_bytes / PEAK_BYTES * 1e3, "bytes"),
        ("preprocess_bwd", "none (the JAX package leaves it to XLA)", bwd,
         plain_bwd, bwd_bytes / PEAK_BYTES * 1e3, "bytes")])
    entries[0]["max_abs_err"] = max(floats_err)
    entries[1]["max_abs_err"] = max(grad_err.values())
    # back to back, a call's host side (checks, allocations, the ctypes
    # call) outlasts its kernel, so CUDA events time the host; the
    # profiler reads the card's own time of every kernel a call launches
    for e, fn, fn_plain in ((entries[0], fwd, plain_fwd),
                            (entries[1], bwd, plain_bwd)):
        e["device_ms"] = device_ms(torch, fn, TIMED_LAUNCHES)
        e["plain_device_ms"] = device_ms(torch, fn_plain, TIMED_LAUNCHES)
        log(f"{e['name']}: the card's time {e['device_ms']:.4f} ms a call "
            f"(plain {e['plain_device_ms']:.4f} ms), bound "
            f"{e['bound_ms']:.4f} ms")
    return entries


def preprocess_ties(torch, p, width, height):
    """The rows of the plain version's outputs p (check_preprocess's dict)
    whose radius or valid flag may round either way between the kernels
    and the plain version (tests/test_torch_preprocess.py near_ties): the
    pre-ceil radius, recomputed from the conic, within PRE_TIE of an
    integer, or a screen bound within PRE_TIE of the position."""
    with torch.no_grad():
        ca, cb, cc = p["conic"].unbind(-1)
        det = ca * cc - cb * cb       # 1 / det of the 2D covariance
        a, b = cc / det, ca / det
        mid = 0.5 * (a + b)
        lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - 1.0 / det, 0.0))
        raw = 3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0))
        tie = (raw - torch.round(raw)).abs() <= PRE_TIE * raw.abs().clamp_min(1.0)
        r = torch.ceil(raw)
        mx, my = p["mean2d"][:, 0], p["mean2d"][:, 1]
        for v, hi in ((mx, width), (my, height)):
            for d in (v + r, v - r - hi):
                tie |= d.abs() <= PRE_TIE * v.abs().clamp_min(1.0)
        return tie


def device_ms(torch, fn, n):
    """Mean ms a call of fn keeps the card busy: the summed device time
    of every kernel, copy and fill of n calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and not e.is_user_annotation())
    return ns / n / 1e6


def ssim64(torch, a, b):
    """train/losses.py ssim_plain in float64, its float32 window cast up."""
    from fusionsense_tpu_torch.train import losses as L

    k1 = torch.tensor(L._window(11, 1.5), dtype=torch.float64,
                      device=a.device)
    x, y = torch.movedim(a.double(), -1, 0), torch.movedim(b.double(), -1, 0)
    return _ssim_of(torch, L._filter2d_batch(
        torch.cat([x, y, x * x, y * y, x * y], dim=0), k1), x.shape[0])


def _ssim_of(torch, f, C, c1=0.01 ** 2, c2=0.03 ** 2):
    """The mean SSIM from the filtered moments f (5 C, Ho, Wo)."""
    mu_a, mu_b = f[:C], f[C:2 * C]
    sig_a = f[2 * C:3 * C] - mu_a * mu_a
    sig_b = f[3 * C:4 * C] - mu_b * mu_b
    sig_ab = f[4 * C:] - mu_a * mu_b
    return torch.mean(((2 * mu_a * mu_b + c1) * (2 * sig_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (sig_a + sig_b + c2)))


def check_ssim(torch, tr):
    """The SSIM kernel pair against its plain version at the cell's shape:
    view 0's render of the trainer's state against its target, the
    cotangent 1. Kernels and plain version are each held to the float64
    evaluation (SSIM_GAP); equal images must give exactly 1 and two calls
    the same bits. Then each kernel, the plain version's forward and
    backward, and the forward through two F.conv2d passes (cuDNN, TF32
    off; the port never calls it) timed with CUDA events beside the
    kernels' byte bounds. Returns the {"kernels"} entries."""
    import torch.nn.functional as F

    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render.rasterize import rasterize
    from fusionsense_tpu_torch.train import losses as L
    from fusionsense_tpu_torch.train import ssim_kernels as SK

    rc = dataclasses.replace(tr.cfg.model.rasterize, tile_capacity=2048)
    with torch.no_grad():
        a = rasterize(*(x[:tr.render_n] for x in activated(tr.gaussians)),
                      tr.camera.index(0), rc, device=tr.device).rgb
        a = a.contiguous()
    b = tr.data.images[0].contiguous()
    H, W, C = a.shape
    floats = (*L._window(11, 1.5), 0.01 ** 2, 0.03 ** 2)
    g = torch.ones((), device=a.device)

    def fwd():
        return SK.ssim_fwd_cuda(a, b, floats, maps=True)

    _, maps = fwd()

    def bwd():
        return SK.ssim_bwd_cuda(a, b, maps, g, floats)

    leaf = a.clone().requires_grad_(True)
    v_plain = L.ssim_plain(leaf, b)

    def plain_fwd():
        return L.ssim_plain(leaf, b)

    def plain_bwd():
        return torch.autograd.grad(v_plain, leaf, retain_graph=True)

    w = torch.tensor(L._window(11, 1.5), device=a.device)

    def library():
        x, y = a.permute(2, 0, 1), b.permute(2, 0, 1)
        st = torch.cat([x, y, x * x, y * y, x * y])[:, None]
        f = F.conv2d(F.conv2d(st, w.view(1, 1, 11, 1)), w.view(1, 1, 1, 11))
        return _ssim_of(torch, f[:, 0], C)

    runs = [(fwd()[0], bwd()) for _ in range(2)]
    torch.cuda.synchronize()
    same = (torch.equal(runs[0][0], runs[1][0])
            and torch.equal(runs[0][1], runs[1][1]))
    with torch.no_grad():
        one = float(L.ssim(a, a.clone()))
    leaf64 = a.double().requires_grad_(True)
    v64 = ssim64(torch, leaf64, b)
    (d64,) = torch.autograd.grad(v64, leaf64)
    (d_plain,) = plain_bwd()
    scale = float(d64.abs().max())
    v_gap = abs(float(runs[0][0]) - float(v64))
    p_gap = abs(float(v_plain.detach()) - float(v64))
    g_gap = float((runs[0][1].double() - d64).abs().max()) / scale
    gp_gap = float((d_plain.double() - d64).abs().max()) / scale
    lib_gap = abs(float(library()) - float(v64))
    log(f"ssim at {H}x{W}x{C} (view 0): mean {float(runs[0][0]):.9f}, "
        f"float64 {float(v64):.9f}; gap to float64: kernel {v_gap:.3e}, plain "
        f"{p_gap:.3e}, conv2d {lib_gap:.3e}; gradient (largest |value| "
        f"{scale:.3e}), gap over that: kernel {g_gap:.3e}, plain "
        f"{gp_gap:.3e}; equal "
        f"images {one!r}; two calls equal to the bit: {same}")
    if not (v_gap <= max(SSIM_GAP * p_gap, SSIM_ATOL)
            and g_gap <= max(SSIM_GAP * gp_gap, SSIM_GRAD_RTOL)
            and one == 1.0 and same):
        raise RuntimeError("ssim: the kernels disagree with the plain version")
    img, n_maps = 4 * H * W * C, 4 * 3 * C * (H - 10) * (W - 10)
    entries = timed_entries("fusionsense_tpu_torch/csrc/ssim.cu", [
        ("ssim_fwd", "none (the JAX package leaves the window to XLA)", fwd,
         plain_fwd, (2 * img + n_maps) / PEAK_BYTES * 1e3, "bytes"),
        ("ssim_bwd", "none (the JAX package leaves the window to XLA)", bwd,
         plain_bwd, (3 * img + n_maps) / PEAK_BYTES * 1e3, "bytes")])
    entries[0]["max_abs_err"] = v_gap
    entries[1]["max_abs_err"] = g_gap * scale
    entries[0]["library_ms"] = cuda_ms(library, TIMED_LAUNCHES, WARM_LAUNCHES)
    for e, fn, fn_plain in ((entries[0], fwd, plain_fwd),
                            (entries[1], bwd, plain_bwd)):
        e["device_ms"] = device_ms(torch, fn, TIMED_LAUNCHES)
        e["plain_device_ms"] = device_ms(torch, fn_plain, TIMED_LAUNCHES)
    log(f"ssim: the card's time a call {entries[0]['device_ms']:.4f} / "
        f"{entries[1]['device_ms']:.4f} ms (plain "
        f"{entries[0]['plain_device_ms']:.4f} / "
        f"{entries[1]['plain_device_ms']:.4f}); F.conv2d forward "
        f"{entries[0]['library_ms']:.4f} ms")
    return entries


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
        launches[k] = launches.get(k, 0) + v
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
    its default meshes, and a second main resumed from its last
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
        resume = out / f"ckpt_{PIPE_ITERS}"
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
    # the resumed run exports from the settled population (step 600 on)
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
        f"{1e3 * times['run'] / (PIPE_RESUME_ITERS - PIPE_ITERS):.2f} ms/step")

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
    if not (entries[-1] == (PIPE_ITERS, frozen_end) and frozen_end > 0
            and pipe2.trainer.step == PIPE_RESUME_ITERS
            and frozen_alive(pipe2.trainer) == frozen_end):
        raise RuntimeError(f"pipeline: the resumed run entered at "
                           f"{entries[-1]}, want ({PIPE_ITERS}, {frozen_end})")
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


def _timed_each(torch, targets, times, results):
    """Wrap each (owner, name) so that every call is timed, device
    synchronised, into the list times[name], and its arguments and result
    kept in results[name]. Returns the originals, to put back."""
    saved = []
    for owner, name in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))

        def timed(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(_name, []).append(time.perf_counter() - t0)
            results.setdefault(_name, []).append((a, out))
            return out
        setattr(owner, name, timed)
    return saved


def _glip_stages(torch, pred, image, enc):
    """CUDA-event ms of the GLIP forward's stages on one preprocessed
    image (as GLIPPredictor.run feeds them), with TF32 off."""
    from fusionsense_tpu_torch.detection.anchors import pyramid_anchors
    from fusionsense_tpu_torch.detection.model import _level_shapes
    from fusionsense_tpu_torch.detection.postprocess import postprocess
    from fusionsense_tpu_torch.priors.tf32 import full_float32

    dev, net = pred.device, pred.net
    ids, mask, pm = (torch.as_tensor(a, device=dev) for a in enc)
    x = torch.from_numpy(image.transpose(2, 0, 1).copy()).to(dev)
    hw = image.shape[:2]
    with torch.inference_mode(), full_float32():
        feats = net.backbone.body(x)
        pyr = net.backbone.fpn(feats)
        lang = net.language_backbone.body.model(ids, mask)
        outs = net.rpn.head(pyr, lang, mask)
        anchors = [torch.from_numpy(a).to(dev)
                   for a in pyramid_anchors(_level_shapes(hw))]
        return {
            "Swin-L": _event_ms(torch, lambda: net.backbone.body(x)),
            "FPN": _event_ms(torch, lambda: net.backbone.fpn(feats)),
            "BERT": _event_ms(torch, lambda: net.language_backbone.body.model(
                ids, mask)),
            "VLDyHead": _event_ms(torch, lambda: net.rpn.head(pyr, lang, mask)),
            "postprocess": _event_ms(torch, lambda: postprocess(
                outs, anchors, pm, hw)),
        }


def touch_path(torch, dev, counters, card, mesh, high):
    """fs-touch in the port (phase 15), touch mode, on a mesh and a
    high-grad cloud: GLIP at full width from a seeded random state dict
    written as the published file wraps it ({"model": ...}, "module."
    prefixes) and loaded back by the CLI through load_glip_checkpoint, the
    toy tokenizer's vocabulary as --glip-vocab. The proposals file is read
    back; no kernel of K1-K4 may launch; each stage is timed; view 0's
    GLIP outputs at min_size TOUCH_CPU_SIZE are held card against CPU, and
    the forward's stages timed at fs-touch's 800x800."""
    import shutil

    import numpy as np

    from fusionsense_tpu_torch import native
    from fusionsense_tpu_torch.cli.touch import main as fs_touch
    from fusionsense_tpu_torch.detection import GLIPModel, GLIPPredictor
    from fusionsense_tpu_torch.detection import convert as GC
    from fusionsense_tpu_torch.detection.model import (
        build_caption, preprocess_image,
    )
    from fusionsense_tpu_torch.detection.tokenizer import WordPieceTokenizer
    from fusionsense_tpu_torch.touch_select import partseg as PS
    from fusionsense_tpu_torch.touch_select import select as SL
    from fusionsense_tpu_torch.utils.ply import read_pcd

    out = SCRATCH / "touch"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    sd = GC.random_state_dict(GLIPModel(), seed=TOUCH_SEED)
    ckpt = out / "glip_random.pth"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, ckpt)
    n_par = sum(v.numel() for v in sd.values())
    del sd
    tok = WordPieceTokenizer.toy([build_caption(list(TOUCH_PARTS))[0]])
    vocab = out / "vocab.txt"
    vocab.write_text("".join(f"{w}\n" for w in sorted(
        tok.vocab, key=tok.vocab.get)))
    log(f"touch: GLIP {n_par / 1e6:.2f} M parameters, random state dict "
        f"written in {time.perf_counter() - t0:.2f} s; vocabulary "
        f"{len(tok.vocab)} words")

    times, results = {}, {}
    saved = _timed_each(torch, [
        (GC, "load_glip_checkpoint"), (SL, "sample_mesh_points"),
        (PS, "render_views"), (GLIPPredictor, "detect"),
        (PS, "superpoints"), (PS, "bbox_vote"), (SL, "fuse_part_ranks"),
        (SL, "propose_touches")], times, results)
    argv = ["--mode", "touch", "--mesh", str(mesh), "--high-grad", str(high),
            "--parts", *TOUCH_PARTS, "--quota", str(TOUCH_QUOTA),
            "--output", str(out / "touch_proposals.pcd"),
            "--glip-checkpoint", str(ckpt), "--glip-vocab", str(vocab),
            "--glip-threshold", str(TOUCH_THRESHOLD)]
    try:
        for c in counters:
            c.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fs_touch(argv, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    n_high = len(read_pcd(high)["points"])
    props = read_pcd(out / "touch_proposals.pcd")
    dets = [r[1] for r in results["detect"]]
    n_boxes = [len(d.labels) for d in dets]
    part_idx = res.seg_part_idx
    ms = {k: [1e3 * t for t in v] for k, v in times.items()}
    glip = ms["detect"]
    log(f"fs-touch: {secs:.3f} s, peak {peak_gb:.3f} GB; stages (ms): "
        f"checkpoint load {ms['load_glip_checkpoint'][0]:.1f}, mesh sampling "
        f"{ms['sample_mesh_points'][0]:.1f} ({len(res.seg_points)} points), "
        f"z-buffer render {ms['render_views'][0]:.1f} "
        f"({len(glip)} views at 400x400), GLIP per view "
        f"{np.mean(glip[1:]):.1f} (first {glip[0]:.1f}; 800x800), "
        f"superpoints (cut-pursuit) {ms['superpoints'][0]:.1f}, vote "
        f"{ms['bbox_vote'][0]:.1f}, proposals "
        f"{ms['fuse_part_ranks'][0] + ms['propose_touches'][0]:.1f}; {card}")
    log(f"fs-touch: boxes per view {n_boxes}; part index counts "
        f"{np.unique(part_idx, return_counts=True)[1].tolist()} (parts "
        f"{np.unique(part_idx).tolist()}); {len(props['points'])} proposals "
        f"from {n_high} high-grad points, part ranks "
        f"{props['part_rank'].astype(int).tolist()}; launches {launches}; "
        f"cut-pursuit from {native.build().relative_to(native.BUILD_DIR.parent.parent)}")
    if len(props["points"]) != min(TOUCH_QUOTA, n_high) or not (
            np.isfinite(props["points"]).all()
            and np.array_equal(props["points"], res.proposals.points)):
        raise RuntimeError(f"fs-touch: {len(props['points'])} proposals read "
                           f"back, want {min(TOUCH_QUOTA, n_high)}")
    if len(dets) != 10 or not sum(n_boxes) or any(launches.values()):
        raise RuntimeError(f"fs-touch: {len(dets)} views, boxes {n_boxes}, "
                           f"launches {launches}")

    # view 0's GLIP outputs, card against CPU, at a reduced image
    pred = results["detect"][0][0][0]
    view0 = results["render_views"][0][1][0]["rgb"]
    image, _ = preprocess_image(view0, TOUCH_CPU_SIZE)
    enc = pred.encode(list(TOUCH_PARTS))
    card_pred = GLIPPredictor(pred.net, pred.tokenizer, TOUCH_CPU_SIZE,
                              TOUCH_THRESHOLD, device=dev)
    cpu_pred = GLIPPredictor(GC.load_glip_checkpoint(str(ckpt)),
                             pred.tokenizer, TOUCH_CPU_SIZE, TOUCH_THRESHOLD,
                             device="cpu")
    det_g, outs_g = card_pred.run(image, *enc)
    t0 = time.perf_counter()
    det_c, outs_c = cpu_pred.run(image, *enc)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    worst = {}
    for lv, (g, c) in enumerate(zip(outs_g, outs_c)):
        for name, a, b in zip(("bbox", "ctr", "dot"), g, c):
            d = (a.cpu() - b).abs()
            scale = float(b.abs().max())
            past = float((d > GLIP_REL * scale).float().mean())
            new = (past, float(d.max()), float(d.max()) / scale)
            worst[name] = tuple(max(x, y) for x, y in zip(
                worst.get(name, new), new))
    same = bool(torch.equal(det_g[2].cpu(), det_c[2])
                and torch.equal(det_g[3].cpu(), det_c[3]))
    log(f"touch view 0, card vs CPU at {image.shape[1]}x{image.shape[0]}: "
        + ", ".join(f"{k} max |d| {v[1]:.3e} ({v[2]:.2e} of its scale), past "
                    f"the limit {v[0]:.2e}" for k, v in worst.items())
        + f"; postprocess labels and valid rows equal: {same}; CPU forward "
        f"{cpu_ms:.0f} ms")
    if any(v[0] > GLIP_FRAC for v in worst.values()):
        raise RuntimeError(f"touch: GLIP on the card disagrees with the CPU: "
                           f"{worst}")
    del cpu_pred

    # the forward's stages on the card at fs-touch's size (view 0)
    image, _ = preprocess_image(view0, pred.min_size)
    torch.cuda.reset_peak_memory_stats()
    stages = _glip_stages(torch, pred, image, enc)
    log(f"touch GLIP stages at {image.shape[1]}x{image.shape[0]} (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; {card}")


def omnidata_path(torch, dev, counters, card, capture):
    """The omnidata normal prior (phase 16) on the pipeline phase's capture
    (a copy): the DPT-Hybrid net at its published width from a seeded
    random state dict, written as the published .ckpt wraps it and loaded
    back through default_normal_model (resolution hd) and
    load_omnidata_checkpoint; generate_priors with its HD normals over every
    frame (7 patches per 640x480 frame), the stored normals read back and
    held to unit length; view 0, card against the CPU at the priors' limits:
    the low path's normals and the HD path's patches (the net's decoded
    outputs), with the merged HD map's gap reported beside them (the host
    merge's cross-fade renormalises sums of the random net's disagreeing
    overlap predictions, which magnifies any difference there); TF32's
    reading beside each; ms per 384x384 forward and per predictor call, peak
    memory. No kernel of K1-K4 may launch."""
    import contextlib
    import shutil

    import numpy as np

    from fusionsense_tpu_torch.data.dataparser import load_rgb
    from fusionsense_tpu_torch.priors import weights as PW
    from fusionsense_tpu_torch.priors.mono_priors import (
        default_normal_model, generate_priors,
    )
    from fusionsense_tpu_torch.priors.omnidata import (
        OmniConfig, OmnidataNormals, OmnidataPredictor,
    )
    from fusionsense_tpu_torch.priors.omnidata import predictor as OP
    from fusionsense_tpu_torch.priors.omnidata.convert import (
        load_omnidata_checkpoint,
    )
    from fusionsense_tpu_torch.priors.omnidata.hd_merge import crop_grid
    from fusionsense_tpu_torch.priors.tf32 import full_float32

    out = SCRATCH / "omnidata"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    scene = out / "scene"
    shutil.copytree(capture, scene)
    t0 = time.perf_counter()
    sd = PW.random_state_dict(OmnidataNormals(OmniConfig()), seed=OMNI_SEED,
                              std=None)
    sd["scratch.output_conv.4.weight"] *= OMNI_HEAD_SCALE
    sd["scratch.output_conv.4.bias"] += torch.tensor(OMNI_BIAS_LIFT)
    ckpt = out / "omnidata_dpt_normal_v2.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, ckpt)
    n_par = sum(v.numel() for v in sd.values())
    del sd
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd = default_normal_model(str(ckpt), model_type="omnidata",
                              resolution="hd", device=dev)
    load_s = time.perf_counter() - t0
    net_cpu, report = load_omnidata_checkpoint(str(ckpt))
    low = OmnidataPredictor(hd.net, "low", device=dev)
    cpu = {r: OmnidataPredictor(net_cpu, r, device="cpu")
           for r in ("low", "hd")}
    log(f"omnidata: DPT-Hybrid {n_par / 1e6:.2f} M parameters, random state "
        f"dict written as {ckpt.name} in {write_s:.2f} s, loaded onto the "
        f"card by default_normal_model(resolution='hd') in {load_s:.2f} s; "
        f"keys missing {len(report['missing'])}, unused "
        f"{len(report['unused'])}")
    if report["missing"] or report["unused"] or not isinstance(
            hd, OmnidataPredictor) or hd.resolution != "hd":
        raise RuntimeError(f"omnidata: checkpoint report {report}, {hd!r}")

    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = generate_priors(scene, normal_model=hd, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    frames = meta["frames"]
    n_all = np.stack([np.load(scene / fr["normal_file_path"]) for fr in frames])
    unit = float(np.abs(np.linalg.norm(n_all, axis=-1) - 1).max())
    n_patches = len(crop_grid(HEIGHT, WIDTH)[2])
    log(f"omnidata: generate_priors over {len(frames)} frames at "
        f"{WIDTH}x{HEIGHT} with HD normals ({n_patches} patches a frame): "
        f"{gen_s:.3f} s, {1e3 * gen_s / len(frames):.1f} ms/frame; normals "
        f"{n_all.shape} | |n| - 1 | <= {unit:.2e}; launches {launches}; {card}")
    if not (n_all.shape == (len(frames), HEIGHT, WIDTH, 3)
            and np.isfinite(n_all).all() and unit <= PRIOR_UNIT_TOL):
        raise RuntimeError("omnidata: a stored normal map is out of range")
    if any(launches.values()):
        raise RuntimeError(f"omnidata: a compositing kernel ran: {launches}")

    # view 0, card against CPU: the low path's output and the HD path's
    # patches (what the card computes), held at the limits, and the merged
    # HD map, reported; the predictors' float32, and TF32 allowed
    rgb0 = load_rgb(scene / frames[0]["file_path"])
    S = OP.IMAGE_SIZE
    crops = crop_grid(HEIGHT, WIDTH)[2]
    cover = np.zeros((HEIGHT, WIDTH), np.int32)
    for py, px in crops.values():
        cover[py:py + S, px:px + S] += 1

    def hd_patches(p):
        x = torch.from_numpy(np.ascontiguousarray(rgb0, np.float32)).to(p.device)
        with torch.inference_mode(), OP.full_float32():
            b = torch.stack([x[py:py + S, px:px + S] for py, px in crops.values()])
            return p._run_patches(b).permute(0, 2, 3, 1).cpu().numpy()

    calls = {"low": lambda r: r["low"].predict_normals(rgb0),
             "hd patches": lambda r: hd_patches(r["hd"]),
             "hd merged": lambda r: r["hd"].predict_normals(rgb0)}
    card_p = {"low": low, "hd": hd}
    want, cpu_ms = {}, {}
    for k, f in calls.items():
        t0 = time.perf_counter()
        want[k] = f(cpu)
        cpu_ms[k] = 1e3 * (time.perf_counter() - t0)

    def readings():
        out = {}
        for k, f in calls.items():
            got = f(card_p)
            out[k] = _past_limit(got, want[k], "normal")
            if k == "hd merged":
                past = np.abs(got - want[k]).max(-1) > PRIOR_NORMAL_ATOL
                out[k] += (float((cover[past] >= 2).mean()) if past.any()
                           else 0.0,)
        return out
    gaps = readings()
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    saved = OP.full_float32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    OP.full_float32 = contextlib.nullcontext
    try:
        tf32 = readings()
    finally:
        OP.full_float32 = saved
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    for k in calls:
        extra = (f" ({100 * gaps[k][2]:.1f}% of them where crops overlap; "
                 f"reported, not held)" if k == "hd merged" else "")
        log(f"omnidata view 0 ({k}), card vs CPU: float32 max |d| "
            f"{gaps[k][0]:.3e}, past the limit {gaps[k][1]:.2e}{extra}; with "
            f"TF32 max |d| {tf32[k][0]:.3e}, past {tf32[k][1]:.2e}; CPU "
            f"{cpu_ms[k]:.0f} ms")

    # ms of the net's forward at 384x384, of each predictor call, and peak
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1, 3, 384, 384), device=dev, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), full_float32():
        fwd_ms = cuda_ms(lambda: hd.net(x), 5, 2)
        batch = x.expand(n_patches, -1, -1, -1).contiguous()
        batch_ms = cuda_ms(lambda: hd.net(batch), 3, 1)
    ms = {r: _event_ms(torch, lambda p=p: p.predict_normals(rgb0))
          for r, p in card_p.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"omnidata: the net's forward at 384x384 {fwd_ms:.2f} ms, "
        f"{n_patches} patches in one batch {batch_ms:.2f} ms; predictor call "
        f"on a {WIDTH}x{HEIGHT} frame (event timed, host pre/post and the HD "
        f"merge included): low {ms['low']:.2f} ms, hd {ms['hd']:.2f} ms; "
        f"peak {peak:.3f} GB; {card}")
    bad = {k: v for k, v in gaps.items()
           if k != "hd merged" and v[1] > PRIOR_FRAC}
    if bad:
        raise RuntimeError(f"omnidata: card and CPU disagree past the limits: "
                           f"{bad}")


def _fs_viewer(args, timeout):
    """Run fs-viewer in a subprocess on `args`; return (seconds to its URL
    line, the line, / bytes, /state, /splats.bin bytes); the subprocess is
    stopped before returning."""
    import select
    import urllib.request

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fusionsense_tpu_torch.cli.viewer", *args,
         "--port", "0"], cwd=Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        while True:
            left = timeout - (time.perf_counter() - t0)
            if left <= 0 or not select.select([proc.stdout], [], [], left)[0]:
                raise RuntimeError(f"fs-viewer {args}: no URL line in "
                                   f"{timeout} s: {lines[-20:]}")
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"fs-viewer {args} exited "
                                   f"{proc.wait()}: {lines[-20:]}")
            lines.append(line.rstrip())
            if line.startswith("viewing "):
                break
        secs = time.perf_counter() - t0
        url = lines[-1].rsplit(" at ", 1)[1]
        get = lambda path: urllib.request.urlopen(  # noqa: E731
            url + path, timeout=60).read()
        return (secs, lines[-1], get(""), json.loads(get("state")),
                get("splats.bin"))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def viewer_path(torch, dev, counters, card, scene, ckpt):
    """The live viewer (phase 17): fs-train --viewer --viewer-port 0
    resumed from the pipeline's last checkpoint for VIEWER_STEPS steps (the
    pipeline's flags, its ViewerCallback on Trainer.run), then /state and
    /splats.bin of its server against the trainer's state, and the time to
    pack and serve a snapshot at that population; then fs-viewer on the
    checkpoint and on its splat PLY, each in a subprocess: the URL line, the
    page, /state and /splats.bin. Returns the K3/K4 launches of the
    resumed run."""
    import shutil
    import urllib.request

    from fusionsense_tpu_torch.cli.train import main as fs_train
    from fusionsense_tpu_torch.gaussians.io import (
        export_splat_ply, import_splat_ply,
    )
    from fusionsense_tpu_torch.train.checkpoint import load_for_inference
    from fusionsense_tpu_torch.viewer import pack_state
    from fusionsense_tpu_torch.viewer import server as VS

    out_root = SCRATCH / "viewer"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    html = (Path(VS.__file__).parent / "viewer.html").read_bytes()
    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = fs_train([
        "--data", str(scene), "--output-dir", str(out_root),
        "--experiment-name", "live", "--load-touches", "--backend", "pallas",
        "--iterations", str(PIPE_ITERS + VIEWER_STEPS), "--warmup-length",
        str(PIPE_WARMUP), "--stop-split-at", str(PIPE_STOP_SPLIT),
        "--add-touch-at", str(PIPE_TOUCH_AT), "--steps-per-save",
        str(PIPE_SAVE), "--resume", str(ckpt), "--mesh", "--skip-eval",
        "--viewer", "--viewer-port", "0"], device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    srv, tr = pipe.viewer_server, pipe.trainer
    try:
        get = lambda path: urllib.request.urlopen(  # noqa: E731
            srv.url + path, timeout=60).read()
        st = json.loads(get("state"))
        served = get("splats.bin")
        want = pack_state(tr.gaussians, VIEWER_MAX)
        n_alive = int(tr.gaussians.num_alive)
        log(f"viewer: fs-train --viewer resumed at step {PIPE_ITERS} for "
            f"{VIEWER_STEPS} steps in {train_s:.2f} s; /state step "
            f"{st['step']} (trainer {tr.step}), num_splats {st['num_splats']} "
            f"(alive {n_alive}), version {st['version']}; /splats.bin "
            f"{len(served)} bytes, equal to pack_state: {served == want}; "
            f"launches {launches}")
        if not (st["step"] == tr.step == PIPE_ITERS + VIEWER_STEPS
                and st["num_splats"] == min(n_alive, VIEWER_MAX)
                and served == want and get("") == html):
            raise RuntimeError(f"viewer: the live server disagrees with the "
                               f"trainer: {st}")
        if not (launches["composite2_fwd"] and launches["composite2_bwd"]) or \
                launches["composite2_fwd_plain"] or launches["composite2_bwd_plain"]:
            raise RuntimeError(f"viewer: launches {launches}")

        # pack and serve a snapshot at the pipeline's population
        times = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = pack_state(tr.gaussians, VIEWER_MAX)
        times["pack"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.update(blob, tr.step)
        times["update"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = get("splats.bin")
        times["GET /splats.bin"] = time.perf_counter() - t0
        if again != blob:
            raise RuntimeError("viewer: the served snapshot is not the packed one")
        log(f"viewer: a snapshot of {n_alive} splats ({len(blob) / 1e6:.2f} "
            f"MB): " + ", ".join(f"{k} {1e3 * v:.2f} ms"
                                 for k, v in times.items()) + f"; {card}")
    finally:
        srv.close()

    # fs-viewer in a subprocess, on the checkpoint and on its splat PLY
    state = load_for_inference(ckpt, device=dev)[0]
    ply = out_root / "splat.ply"
    n_ply = export_splat_ply(ply, state)
    for flag, path, src in (("--checkpoint", ckpt, state),
                            ("--ply", ply, import_splat_ply(ply, device=dev))):
        secs, line, page, st, blob = _fs_viewer([flag, str(path)], VIEWER_WAIT)
        want = pack_state(src, VIEWER_MAX)
        log(f"fs-viewer {flag} {path.name}: URL line after {secs:.2f} s "
            f"({line!r}); page {len(page)} bytes, /state num_splats "
            f"{st['num_splats']} step {st['step']}, /splats.bin {len(blob)} "
            f"bytes, equal to pack_state: {blob == want}")
        if not (page == html and st["num_splats"] == len(want) // 32
                == min(n_ply, VIEWER_MAX) and blob == want):
            raise RuntimeError(f"fs-viewer {flag}: served {st}, want "
                               f"{len(want) // 32} splats")
    return launches


def nerf_path(torch, dev, counters, card, scene):
    """The NeRF baseline (phase 18) on the pipeline phase's capture:
    NerfConfig()'s published defaults with the depth loss on, NERF_STEPS
    Adam steps of NerfConfig.rays_per_step rays drawn from a generator on
    the card; the PSNR of the last NERF_WINDOW steps must exceed that of the
    first; one step and one full-resolution render_image timed with CUDA
    events, peak memory. No kernel of K1-K4 may launch."""
    import numpy as np

    from fusionsense_tpu_torch.baselines import nerf as NF
    from fusionsense_tpu_torch.data.dataparser import (
        DataParserConfig, load_train_data, parse_transforms,
    )

    dcfg = DataParserConfig(data_dir=str(scene))
    cams, data = load_train_data(parse_transforms(dcfg, device=dev), dcfg,
                                 "train")
    images, depths = data.images, data.sensor_depths
    V, H, W = images.shape[:3]
    cfg = dataclasses.replace(NF.NerfConfig(), depth_lambda=NERF_DEPTH_LAMBDA)
    gen = torch.Generator(device=dev).manual_seed(NERF_SEED)
    params = NF.init_params(gen, cfg, dev)
    init, chunk = NF.make_train_step(cfg, cams, images, depths)
    state = init(params)
    for c in counters:
        c.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psnr = []
    for _ in range(NERF_STEPS // NERF_CHUNK):
        draws = [NF.draw_rays(gen, cfg, V, H, W, dev) for _ in range(NERF_CHUNK)]
        params, state, m = chunk(params, state, draws)
        psnr.append(m["psnr"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    psnr = torch.cat(psnr).cpu().numpy()
    first, last = (float(psnr[:NERF_WINDOW].mean()),
                   float(psnr[-NERF_WINDOW:].mean()))
    draw = NF.draw_rays(gen, cfg, V, H, W, dev)
    step_ms = _event_ms(torch, lambda: chunk(params, state, [draw]), n=5)
    cam0 = cams.index(0)
    img = NF.render_image(params, cam0, cfg)
    render_ms = _event_ms(torch, lambda: NF.render_image(params, cam0, cfg),
                          n=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    log(f"nerf: {NERF_STEPS} steps of {cfg.rays_per_step} rays x "
        f"{cfg.n_samples} samples ({cfg.n_levels} levels, table "
        f"2^{cfg.table_size_log2}, depth lambda {cfg.depth_lambda}) on "
        f"{V} views at {W}x{H} in {train_s:.2f} s; PSNR first "
        f"{NERF_WINDOW} {first:.3f}, last {NERF_WINDOW} {last:.3f}; one step "
        f"{step_ms:.2f} ms, render_image at {W}x{H} {render_ms:.1f} ms "
        f"(CUDA events); peak {peak:.3f} GB; launches {launches}; {card}")
    if not (np.isfinite(psnr).all() and last > first):
        raise RuntimeError(f"nerf: PSNR did not rise: {first} -> {last}")
    if not (img["rgb"].shape == (H, W, 3) and np.isfinite(img["rgb"]).all()
            and np.isfinite(img["depth"]).all()):
        raise RuntimeError("nerf: the rendered image is not finite")
    if any(launches.values()):
        raise RuntimeError(f"nerf: a compositing kernel ran: {launches}")


def _shard_blocks_flat(torch, pre, cam, rc, n, pairs=None):
    """The flat tables of the n tile blocks of a tile-sharded mesh (the
    sharded step's render/rasterize.py tile_table over its block): (table,
    runs, counts, T_loc, tile_lo, block-aligned pairs) each. With `pairs`
    (the unsharded layout's aligned pair total, which bounds every block's)
    each block's budget holds that many; no block may drop a pair."""
    from fusionsense_tpu_torch.parallel.sharded import tile_block
    from fusionsense_tpu_torch.render import flat_composite as FC
    from fusionsense_tpu_torch.render.rasterize import tile_table
    from fusionsense_tpu_torch.render.composite import TileGrid

    T = TileGrid(cam.width, cam.height, rc.tile_size).num_tiles
    out = []
    for me in range(n):
        _, t_loc, lo = tile_block(T, n, me)
        rc_me = rc if pairs is None else dataclasses.replace(
            rc, tile_capacity=-(-pairs // t_loc))
        with torch.no_grad():
            tt = tile_table(pre, cam, rc_me, tile_lo=lo, num_tiles_local=t_loc)
        table, fb = tt.table, tt.bins
        if int(fb.overflow):
            raise RuntimeError(f"sharded: block {me}/{n} dropped "
                               f"{int(fb.overflow)} pairs")
        out.append((table.contiguous(), FC.tile_runs(fb.blk_tile, t_loc),
                    fb.blk_count.to(torch.int32).contiguous(), t_loc, lo,
                    int(fb.used)))
    return out


def check_sharded_kernels(torch, cams, init, cfg):
    """K1/K2 at tile_lo and K3/K4 at offset tile ids, on view 0's real
    tables of the initial state: each block of SHARD_SPLITS shard counts
    against the plain versions (out / alpha at TOL_OUT / TOL_ALPHA, dtab
    column by column at TOL_DTAB_REL, K2/K4 fed the unsharded cotangents of
    the block's tiles), and the blocks' outputs concatenated against the
    unsharded kernel's. Returns the largest errors by kernel key."""
    from fusionsense_tpu_torch.gaussians.store import activated
    from fusionsense_tpu_torch.render import composite2 as C2
    from fusionsense_tpu_torch.render import flat_composite as FC
    from fusionsense_tpu_torch.render import rasterize as R
    from fusionsense_tpu_torch.render.composite import TileGrid

    cam = cams.index(0)
    dev = cam.device
    errs = {"flat_composite_fwd": 0.0, "flat_composite_bwd": 0.0,
            "composite2_fwd": 0.0, "composite2_bwd": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)

    def cotangents(T, C, P):
        return (G_SCALE * torch.randn((T, C, P), generator=gen, device=dev),
                G_SCALE * torch.randn((T, P), generator=gen, device=dev))

    def hold(key, what, err, tol):
        errs[key] = max(errs[key], err)
        if not err <= tol:
            raise RuntimeError(f"sharded: {what} max|d| {err:.3e} past "
                               f"{tol:.0e}")

    # K1/K2: the bench's flat configuration
    rc = dataclasses.replace(cfg.model.rasterize,
                             tile_capacity=SHARD_TILE_CAPACITY)
    grid = TileGrid(cam.width, cam.height, rc.tile_size)
    T, P, B = grid.num_tiles, grid.pixels_per_tile, rc.pallas_chunk
    tx, ts = grid.tiles_x, rc.tile_size
    with torch.no_grad():
        m, q, s, o, c = activated(init)
        normals = R.gaussian_flat_normals(q, s, m, cam.origin)
        pre = R.prepare(m, q, s, o, c, cam, rc, normals, None)
    ((table, runs, count, _, _, pairs),) = _shard_blocks_flat(torch, pre, cam,
                                                              rc, 1)
    out_f, logt_f, _, _, _ = FC.flat_composite_fwd_cuda(table, runs, count,
                                                        T, tx, ts, B)
    C = table.shape[1] - 8
    g_out, g_logt = cotangents(T, C, P)
    for n in SHARD_SPLITS:
        outs, logts = [], []
        for me, (table, runs, count, t_loc, lo, _) in enumerate(
                _shard_blocks_flat(torch, pre, cam, rc, n, pairs)):
            geo = (t_loc, tx, ts, B)
            o_k, lt, carry, acc, live = FC.flat_composite_fwd_cuda(
                table, runs, count, *geo, tile_lo=lo)
            torch.cuda.synchronize()
            o_p, lt_p, _, _, live_p = FC.flat_composite_fwd_plain(
                table, runs, count, *geo, tile_lo=lo)
            if not torch.equal(live, live_p):
                raise RuntimeError(f"sharded: K1 block {me}/{n}: live flags "
                                   "differ from the plain version's")
            hold("flat_composite_fwd", f"K1 block {me}/{n} out",
                 max_err(o_k, o_p), TOL_OUT)
            hold("flat_composite_fwd", f"K1 block {me}/{n} alpha",
                 max_err(torch.exp(lt), torch.exp(lt_p)), TOL_ALPHA)
            go = torch.zeros((t_loc + 1, C, P), device=dev)
            gl = torch.zeros((t_loc + 1, P), device=dev)
            k = max(0, min(t_loc, T - lo))
            go[:k], gl[:k] = g_out[lo:lo + k], g_logt[lo:lo + k]
            bwd_args = (table, runs, go, gl, lt, carry, acc, live, tx, ts, B)
            dtab = FC.flat_composite_bwd_cuda(*bwd_args, tile_lo=lo)
            torch.cuda.synchronize()
            errs["flat_composite_bwd"] = max(
                errs["flat_composite_bwd"],
                check_columns(f"K2 block {me}/{n} at tile_lo {lo}", dtab,
                              FC.flat_composite_bwd_plain(*bwd_args,
                                                          tile_lo=lo)))
            outs.append(o_k[:t_loc])
            logts.append(lt[:t_loc])
        hold("flat_composite_fwd", f"K1's {n} blocks against the unsharded",
             max_err(torch.cat(outs)[:T], out_f[:T]), TOL_OUT)
        hold("flat_composite_fwd", f"K1's {n} blocks' alpha",
             max_err(torch.exp(torch.cat(logts)[:T]), torch.exp(logt_f[:T])),
             TOL_ALPHA)

    # K3/K4: phase 7's dense configuration
    rd = dense_config().model.rasterize
    with torch.no_grad():
        normals = R.gaussian_flat_normals(q, s, m, cam.origin)
        dt = R.tile_table(R.prepare(m, q, s, o, c, cam, rd, normals, None),
                          cam, rd)
    grid = TileGrid(cam.width, cam.height, rd.tile_size)
    T, P, B = grid.num_tiles, grid.pixels_per_tile, rd.pallas_chunk
    tx, ts = grid.tiles_x, rd.tile_size
    table, counts = dt.table.contiguous(), dt.counts.contiguous()
    ids = torch.arange(T, dtype=torch.int32, device=dev)
    out_f, logt_f = C2.composite2_fwd_cuda(table, counts, ids, tx, ts, B)[:2]
    g_out, g_logt = cotangents(T, C, P)
    for n in SHARD_SPLITS:
        t_loc = -(-T // n)
        outs, logts = [], []
        for me in range(n):
            r = slice(me * t_loc, min((me + 1) * t_loc, T))
            tb, cn, ti = (x[r].contiguous() for x in (table, counts, ids))
            o_k, lt, carries, nused, acc = C2.composite2_fwd_cuda(
                tb, cn, ti, tx, ts, B)
            torch.cuda.synchronize()
            o_p, lt_p, _, nused_p, _ = C2.composite2_fwd_plain(tb, cn, ti, tx,
                                                               ts, B)
            if not torch.equal(nused, nused_p):
                raise RuntimeError(f"sharded: K3 block {me}/{n}: nused "
                                   "differs from the plain version's")
            hold("composite2_fwd", f"K3 block {me}/{n} out",
                 max_err(o_k, o_p), TOL_OUT)
            hold("composite2_fwd", f"K3 block {me}/{n} alpha",
                 max_err(torch.exp(lt), torch.exp(lt_p)), TOL_ALPHA)
            bwd_args = (tb, nused, ti, g_out[r].contiguous(),
                        g_logt[r].contiguous(), lt, carries, acc, tx, ts, B)
            dtab = C2.composite2_bwd_cuda(*bwd_args)
            torch.cuda.synchronize()
            errs["composite2_bwd"] = max(
                errs["composite2_bwd"],
                check_columns(f"K4 block {me}/{n} at tile ids {r.start}..",
                              dtab, C2.composite2_bwd_plain(*bwd_args)))
            outs.append(o_k)
            logts.append(lt)
        hold("composite2_fwd", f"K3's {n} blocks against the unsharded",
             max_err(torch.cat(outs), out_f), TOL_OUT)
        hold("composite2_fwd", f"K3's {n} blocks' alpha",
             max_err(torch.exp(torch.cat(logts)), torch.exp(logt_f)),
             TOL_ALPHA)
    log("sharded: K1/K2 at tile_lo and K3/K4 at offset tile ids, "
        f"{list(SHARD_SPLITS)} blocks of view 0, against their plain "
        f"versions and the unsharded kernels: max|d| {errs}")
    return errs


def _state_digest(torch, tr) -> str:
    """sha256 of a ShardedTrainer's store, gathered moments and stats."""
    import hashlib

    opt = tr.full_opt()
    h = hashlib.sha256()
    for t in [*tr.gaussians.fields().values(),
              *(v for tree in (opt.m, opt.v, opt.acc, opt.counts)
                for v in tree.values()), *tr.stats.fields().values()]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _sharded_work(torch, dev, scene, cfgs, out_dir):
    """One rank's share of the sharded phase: the one-step check, then the
    flat and the dense ShardedTrainer (ZeRO-1). Returns, on rank 0, what the
    parent reports; launch counts and digests are gathered over the ranks."""
    import torch.distributed as dist

    from fusionsense_tpu_torch.core.cameras import Camera
    from fusionsense_tpu_torch.gaussians.adc import init_stats
    from fusionsense_tpu_torch.gaussians.store import GaussianState
    from fusionsense_tpu_torch.parallel import comm
    from fusionsense_tpu_torch.parallel.mesh import make_mesh
    from fusionsense_tpu_torch.parallel.sharded import (
        gather_opt, make_sharded_train_step, shard_opt,
    )
    from fusionsense_tpu_torch.parallel.trainer import ShardedTrainer
    from fusionsense_tpu_torch.render import composite2 as C2
    from fusionsense_tpu_torch.render import flat_composite as FC
    from fusionsense_tpu_torch.train.optim import adam_step, init_adam
    from fusionsense_tpu_torch.train.trainer import TrainData, compute_losses

    mesh = make_mesh(**SHARD_AXES, device=dev)
    cams = Camera(**scene["camera"])
    data = TrainData(**scene["data"])
    init = GaussianState(**scene["init"])
    flat_cfg, dense_cfg = cfgs
    rank0 = mesh.rank == 0
    res = {}
    views = list(range(mesh.shape["data"]))

    def fresh():
        return init.replace(**{k: v.clone() for k, v in init.fields().items()})

    def cam_state():
        z6 = torch.zeros((cams.viewmat.shape[0], 6), device=dev)
        return z6, init_adam({"cam_delta": z6})

    # 1. one sharded step from the initial state, replicated and ZeRO-1
    step_cfg = dataclasses.replace(flat_cfg, model=dataclasses.replace(
        flat_cfg.model, rasterize=dataclasses.replace(
            flat_cfg.model.rasterize, tile_capacity=SHARD_TILE_CAPACITY)))
    got = {}
    for zero in (False, True):
        g = fresh()
        opt = init_adam(g.params())
        if zero:
            opt = shard_opt(mesh, opt)
        step = make_sharded_train_step(step_cfg, cams, data, mesh,
                                       shard_optimizer=zero)
        g2, opt2, _, _, metrics = step(g, opt, cam_state(),
                                       init_stats(g.capacity, dev), 0, views)
        if zero:
            opt2 = gather_opt(mesh, opt2)
        got[zero] = (g2.params(), opt2.m, metrics)
    if rank0:
        g = fresh()
        grads = None
        for v in views:
            params = {k: p.detach().requires_grad_(True)
                      for k, p in g.params().items()}
            tap = torch.zeros((g.capacity, 2), device=dev, requires_grad=True)
            total, (_, aux) = compute_losses(g.replace(**params), cams, data, v,
                                             0, step_cfg, tap)
            if int(aux["overflow"]):
                raise RuntimeError(f"sharded: the single-device reference "
                                   f"dropped {int(aux['overflow'])} pairs "
                                   f"of view {v} ({int(aux['pairs_used'])} "
                                   f"kept)")
            gi = torch.autograd.grad(total, list(params.values()),
                                     allow_unused=True)
            gi = {k: torch.zeros_like(params[k]) if x is None else x
                  for k, x in zip(params, gi)}
            grads = gi if grads is None else {k: grads[k] + gi[k] for k in gi}
        grads = {k: x / len(views) for k, x in grads.items()}
        ref_p, ref_opt = adam_step(g.params(), grads, init_adam(g.params()),
                                   0, g.alive)

        def past(a, b, atol, rtol):
            """max|a - b| and the elements past atol + rtol |b|."""
            d = (a - b).abs()
            return float(d.max()), int((d > atol + rtol * b.abs()).sum())

        def scaled(a, b, limit):
            """max|a - b| / max|b|, and 1 where it is past `limit` (or not
            a number: a zero reference holds nothing)."""
            r = float((a - b).abs().max() / b.abs().max())
            return r, int(not r <= limit)

        p_rep, m_rep, met = got[False]
        p_z1, m_z1, _ = got[True]
        res["step"] = {
            "means": past(p_rep["means"], ref_p["means"], **TOL_SHARD),
            "m.means": past(m_rep["means"], ref_opt.m["means"],
                            **TOL_SHARD_M),
            "m.means / max|m_ref|": scaled(m_rep["means"], ref_opt.m["means"],
                                           TOL_SHARD_SCALE),
            "max|m_ref.means|": float(ref_opt.m["means"].abs().max()),
            "zero1 means": past(p_z1["means"], p_rep["means"], **TOL_ZERO1),
            "zero1 features_dc": past(p_z1["features_dc"],
                                      p_rep["features_dc"], **TOL_ZERO1),
            "zero1 m.means": past(m_z1["means"], m_rep["means"], **TOL_ZERO1),
            "zero1 m.means / max|m|": scaled(m_z1["means"], m_rep["means"],
                                             TOL_ZERO1_SCALE),
            "overflow": int(met["overflow"]), "loss": float(met["loss"])}

    # 2. the trainers: ZeRO-1, a refine every SHARD_ADC, logged every
    # SHARD_LOG; launches, the collectives and the state's digest per run
    res["runs"] = {}
    for name, cfg in (("flat", flat_cfg), ("dense", dense_cfg)):
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, iterations=SHARD_STEPS, log_every=SHARD_LOG,
            adc=dataclasses.replace(cfg.train.adc, **SHARD_ADC)))
        tr = ShardedTrainer(cfg, cams, data, fresh(), mesh,
                            shard_optimizer=True)
        psnr0 = view_psnr(torch, tr, 0) if rank0 else None
        FC.reset_launch_counts()
        C2.reset_launch_counts()
        comm.reset_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        tr.run(log=None)
        torch.cuda.synchronize()
        dist.barrier()
        secs = time.perf_counter() - t0
        launches = {**FC.LAUNCHES, **C2.LAUNCHES}
        calls = {f"{op} calls": n for op, n in comm.COUNTS.items()}
        sent = {f"{op} MB": comm.BYTES[op] / 1e6 for op in comm.OPS}
        keys = sorted(launches)
        summed = torch.tensor([launches[k] for k in keys], device=dev)
        dist.all_reduce(summed)
        digests = [None] * mesh.size
        dist.all_gather_object(digests, _state_digest(torch, tr))
        if name == "flat":
            tr.save(out_dir / "ckpt_flat")
        if rank0:
            res["runs"][name] = {
                "ms_step": secs * 1e3 / SHARD_STEPS,
                "launches": dict(zip(keys, summed.tolist())),
                "rank0 collectives per step": {
                    k: v / SHARD_STEPS for k, v in {**calls, **sent}.items()},
                "digests equal": len(set(digests)) == 1,
                "logged psnr": [(r["step"], r["psnr"]) for r in tr.history],
                "view-0 psnr": (psnr0, view_psnr(torch, tr, 0)),
                "alive": (int(init.num_alive), int(tr.gaussians.num_alive)),
                "nonfinite": sum(r["nonfinite_steps"] for r in tr.history),
                "render_n": tr.render_n, "capacity": tr.gaussians.capacity}

    # what the step's collectives cost alone, at the flat run's sizes: the
    # parameter gradients (ZeRO-1's SUM over the shard axes, then its
    # reduce-scatter over data), the image block's gather over tile
    width = sum(x[0].numel() for x in init.params().values())
    grads = torch.ones(init.capacity * width, device=dev)
    block = torch.ones(_shard_pixels(cams, flat_cfg, mesh), device=dev)
    timed = {}
    for name, fn in (
            ("SUM over tile x gauss", lambda: comm.psum(
                mesh, grads, ("tile", "gauss"))),
            ("reduce-scatter over data", lambda: comm.psum_scatter(
                mesh, grads.reshape(mesh.shape["data"], -1), "data")),
            ("image block all_gather over tile", lambda: comm.all_gather(
                mesh, block, "tile"))):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        timed[name] = (time.perf_counter() - t0) * 1e3 / 5
    if rank0:
        res["collective ms"] = timed
        res["collective MB"] = (grads.numel() * 4 / 1e6,
                                block.numel() * 4 / 1e6)
    return res


def _shard_pixels(cams, cfg, mesh):
    """Values of one rank's composited tile block: T_loc tiles x P pixels x
    (7 channels and alpha)."""
    from fusionsense_tpu_torch.parallel.sharded import tile_block
    from fusionsense_tpu_torch.render.composite import TileGrid

    grid = TileGrid(cams.width, cams.height, cfg.model.rasterize.tile_size)
    _, t_loc, _ = tile_block(grid.num_tiles, mesh.shape["tile"], 0)
    return t_loc * grid.pixels_per_tile * 8


def _sharded_rank(rank, url, scene_path, cfgs, out_dir, results):
    """A spawned rank of the sharded phase: start the rank on the card
    (parallel.mesh.init_ranks: gloo, the ranks share it), run its share and
    report (rank, ok, result or traceback)."""
    import os
    import traceback

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(SHARD_RANKS),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(SHARD_RANKS))
    try:
        import torch

        from fusionsense_tpu_torch.parallel.mesh import init_ranks

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = init_ranks(init_method=url)
        scene = torch.load(scene_path, map_location=dev, weights_only=True)
        out = _sharded_work(torch, dev, scene, cfgs, out_dir)
        torch.distributed.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def _spawn_ranks(target, args, n, wait):
    """Run target(rank, *args, results) in n spawned processes; returns rank
    0's result. Any rank's failure or death, or a rank silent for `wait`
    seconds, kills them all and raises."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, *args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + wait
    try:
        while len(out) < n:
            try:
                rank, ok, res = results.get(timeout=2.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"sharded: ranks {dead} died" if dead
                                       else f"sharded: no answer in {wait} s")
                continue
            if not ok:
                raise RuntimeError(f"sharded: rank {rank} failed:\n{res}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return out[0]


def _fs_train_torchrun(scene, out_root, dev, card):
    """fs-train --device-mesh through torchrun on the capture: 8 ranks on
    the card, an empty --mesh, the flat backend; rank 0's artifacts read
    back and its logged PSNR rising. Returns (seconds, psnr log)."""
    import re

    from fusionsense_tpu_torch.train.checkpoint import load_checkpoint_full
    from fusionsense_tpu_torch.utils.ply import read_pcd

    mesh_flag = ",".join(f"{k}={v}" for k, v in SHARD_AXES.items())
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(SHARD_RANKS), "-m",
           "fusionsense_tpu_torch.cli.train", "--data", str(scene),
           "--output-dir", str(out_root), "--backend", "flat",
           "--iterations", str(SHARD_CLI_ITERS), "--warmup-length",
           str(SHARD_CLI_WARMUP), "--stop-split-at",
           str(SHARD_CLI_WARMUP + 500), "--steps-per-save",
           str(SHARD_CLI_ITERS), "--mesh", "--device-mesh", mesh_flag]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=SHARD_WAIT, cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    (out_root / "torchrun.log").parent.mkdir(parents=True, exist_ok=True)
    (out_root / "torchrun.log").write_text(run.stdout + run.stderr)
    if run.returncode:
        raise RuntimeError(f"sharded: torchrun fs-train exited "
                           f"{run.returncode}:\n{run.stderr[-4000:]}")
    psnr = [(int(a), float(b)) for a, b in re.findall(
        r"step\s+(\d+)\s+loss\s+\S+\s+psnr\s+(\S+)", run.stdout)]
    rule = [ln for ln in run.stdout.splitlines()
            if ln.startswith("fusionsense_tpu_torch.parallel:")]
    out = out_root / "dn_splatter"
    g, _, _, step, _, meta = load_checkpoint_full(
        out / f"ckpt_{SHARD_CLI_ITERS}", device=dev)
    metrics = json.loads((out / "metrics.json").read_text())["mean"]
    hg = read_pcd(out / "high_grad_pts.pcd")
    log(f"sharded: fs-train --device-mesh {mesh_flag} through torchrun "
        f"({SHARD_RANKS} ranks sharing one card, not a scaling number): "
        f"{SHARD_CLI_ITERS} steps in {secs:.1f} s wall (start-up, eval and "
        f"saves included); {rule}; logged PSNR {psnr}; ckpt_{step}: "
        f"{int(g.num_alive)} alive; metrics.json psnr "
        f"{metrics.get('psnr')}; high-grad points {len(hg['points'])}; {card}")
    if not (step == SHARD_CLI_ITERS and len(psnr) >= 2
            and psnr[-1][1] > psnr[0][1] and meta["history"]
            and math.isfinite(metrics.get("psnr", math.nan))):
        raise RuntimeError(f"sharded: torchrun fs-train's artifacts or PSNR "
                           f"fail: step {step}, PSNR {psnr}")
    return secs, psnr


def sharded_path(torch, dev, card, cams, data, init, cfg):
    """The sharded phase: K1-K4 at the blocks' global tiles in this process,
    then the one-step check and the two ShardedTrainer runs in SHARD_RANKS
    spawned ranks, rank 0's checkpoint restored into a single-device
    Trainer, and fs-train --device-mesh through torchrun. Returns (errs,
    launches summed over the ranks)."""
    import shutil

    from fusionsense_tpu_torch.train.trainer import Trainer

    errs = check_sharded_kernels(torch, cams, init, cfg)
    root = SCRATCH / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cpu = lambda x: x.detach().cpu()  # noqa: E731
    torch.save({
        "camera": {"viewmat": cpu(cams.viewmat), "fx": cpu(cams.fx),
                   "fy": cpu(cams.fy), "cx": cpu(cams.cx), "cy": cpu(cams.cy),
                   "width": cams.width, "height": cams.height},
        "data": {f.name: cpu(getattr(data, f.name))
                 for f in dataclasses.fields(data)
                 if getattr(data, f.name) is not None},
        "init": {k: cpu(v) for k, v in init.fields().items()}},
        root / "scene.pt")
    t0 = time.perf_counter()
    res = _spawn_ranks(_sharded_rank,
                       (f"file://{root}/rendezvous", str(root / "scene.pt"),
                        (cfg, dense_config()), root),
                       SHARD_RANKS, SHARD_WAIT)
    spawn_s = time.perf_counter() - t0
    log(f"sharded: collectives alone on {SHARD_RANKS} ranks sharing one card "
        f"(gloo), the gradient buffer and the image block "
        f"{res['collective MB']} MB: {res['collective ms']} ms; {card}")
    st = res["step"]
    log(f"sharded: one step on {SHARD_RANKS} ranks "
        f"({', '.join(f'{k}={v}' for k, v in SHARD_AXES.items())}) against "
        f"the single-device batch-mean step, (max|d|, elements past the "
        f"limit) or (max|d| / max|reference|, past the limit): {st}")
    if any(v[1] for k, v in st.items() if isinstance(v, tuple)) or \
            st["overflow"]:
        raise RuntimeError(f"sharded: the sharded step disagrees: {st}")
    launches = {}
    for name, r in res["runs"].items():
        keys = (("flat_composite_fwd", "flat_composite_bwd") if name == "flat"
                else ("composite2_fwd", "composite2_bwd"))
        log(f"sharded {name}: ShardedTrainer ZeRO-1, {SHARD_STEPS} steps, "
            f"{r['ms_step']:.1f} ms/step ({SHARD_RANKS} ranks sharing one "
            f"card, not a scaling number); {card}; view-0 PSNR "
            f"{r['view-0 psnr'][0]:.3f} -> {r['view-0 psnr'][1]:.3f}; logged "
            f"PSNR {r['logged psnr']}; "
            f"alive {r['alive'][0]} -> {r['alive'][1]}, render_n "
            f"{r['render_n']}, capacity {r['capacity']}; launches summed "
            f"over the ranks {r['launches']}; rank 0's collectives per step "
            f"{r['rank0 collectives per step']}; the ranks' states "
            f"bit-equal: {r['digests equal']}")
        psnr = r["view-0 psnr"]
        if not (r["digests equal"] and r["nonfinite"] == 0
                and psnr[1] > psnr[0] and r["alive"][1] != r["alive"][0]):
            raise RuntimeError(f"sharded {name}: {r}")
        if any(r["launches"][k] < SHARD_STEPS * SHARD_RANKS for k in keys) \
                or any(r["launches"][f"{k}_plain"] for k in keys):
            raise RuntimeError(f"sharded {name}: launches {r['launches']}")
        launches.update({k: r["launches"][k] for k in keys})

    # rank 0's checkpoint into the single-device trainer
    tr = Trainer(cfg, cams, data, init.replace(
        **{k: v.clone() for k, v in init.fields().items()}), device=dev)
    tr.restore(root / "ckpt_flat")
    step0 = tr.step
    tr.run(iterations=step0 + SHARD_RESUME_STEPS, log=None)
    loss = tr.history[-1]["loss"]
    log(f"sharded: rank 0's ckpt_flat (step {step0}) restored into a "
        f"single-device Trainer, {SHARD_RESUME_STEPS} more steps: loss "
        f"{loss:.5f}; ranks spawned, checked and run in {spawn_s:.1f} s")
    if not (step0 == SHARD_STEPS and math.isfinite(loss)):
        raise RuntimeError(f"sharded: the restored run fails: {loss}")

    # fs-train --device-mesh through torchrun on a copy of the capture
    shutil.copytree(SCRATCH / "blob", root / "blob")
    _fs_train_torchrun(root / "blob", root / "cli", dev, card)
    return errs, launches


def long_envelope(ref):
    """{step: {key: (lo, hi)}} for num_gaussians and psnr_views from the
    JAX seeds' trajectories of LONG_REF."""
    import numpy as np

    env = {}
    for b in ref["boundaries"]:
        e = {}
        for k, floor in (("num_gaussians", None),
                         ("psnr_views", LONG_PSNR_FLOOR)):
            v = np.asarray(b[k], np.float64)
            mean = float(v.mean())
            sd = float(v.std(ddof=1)) if v.size > 1 else 0.0
            half = max(2 * sd, LONG_ALIVE_FLOOR * mean if floor is None
                       else floor)
            e[k] = (mean - half, mean + half)
        env[b["step"]] = e
    return env


def long_parity_path(torch, dev, counters, card):
    """The long-parity phase (20): the CPU harness's scene on the card,
    run_fused with CUDA graphs of K1/K2's step to LONG_STEPS for each seed,
    the seed-means at every LONG_EVERY boundary held to the JAX envelope.
    The launch counters are zeroed just before and read just after; K1/K2
    must launch at every step, their plain twins never. Returns the
    launches."""
    from fusionsense_tpu_torch.eval.evaluator import view_psnrs
    from fusionsense_tpu_torch.train import graphs as G
    from fusionsense_tpu_torch.train.trainer import Trainer

    env = long_envelope(json.loads(LONG_REF.read_text()))
    t_start = time.perf_counter()
    cams, data, init, cfg, gt_budget = build_scene(
        torch, dev, width=LONG_W, height=LONG_H, n_gt=LONG_GT,
        n_init=LONG_INIT, capacity=LONG_CAPACITY, tile=LONG_TILE,
        focal=FOCAL * LONG_W / 640)
    ivl = cfg.train.adc.refine_every
    for c in counters:
        c.reset_launch_counts()
    G.reset_launch_counts()
    runs, nonfinite, rate = {}, 0, []
    for seed in LONG_SEEDS:
        cfg_s = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=seed))
        tr = Trainer(cfg_s, cams, data, init.replace(
            **{k: v.clone() for k, v in init.fields().items()}), device=dev)
        rows, train_s = {}, 0.0
        while tr.step < LONG_STEPS:
            t0 = time.perf_counter()
            tr.sync_policies(tr.run_fused(LONG_EVERY // ivl))
            train_s += time.perf_counter() - t0
            psnrs = view_psnrs(tr.gaussians, cams, data.images,
                               cfg.model.rasterize)
            rows[tr.step] = {"num_gaussians": tr.history[-1]["num_gaussians"],
                             "psnr_views": sum(psnrs) / len(psnrs)}
        nonfinite += sum(r["nonfinite_steps"] for r in tr.history)
        rate.append(train_s * 1e3 / LONG_STEPS)
        runs[seed] = rows
        log(f"long parity seed {seed}: {tr.step} steps, "
            f"{rate[-1]:.3f} ms/step with the policy syncs; alive "
            f"{rows[tr.step]['num_gaussians']}, 9-view PSNR "
            f"{rows[tr.step]['psnr_views']:.4f}; graphs {tr.graph_stats()}")
        del tr
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    for k, v in G.REPLAYED.items():
        launches[k] = launches.get(k, 0) + v
    misses = []
    for step in sorted(env):
        have = [r[step] for r in runs.values() if step in r]
        if not have:
            continue
        parts, miss = [], []
        for k, (lo, hi) in env[step].items():
            m = sum(h[k] for h in have) / len(have)
            parts.append(f"{k} {m:.4f} in [{lo:.4f}, {hi:.4f}]")
            if not lo <= m <= hi:
                miss.append((step, k, m, lo, hi))
        misses += miss
        log(f"long parity step {step}: seed-mean " + "; ".join(parts)
            + ("  MISS" if miss else ""))
    log(f"long parity: {len(LONG_SEEDS)} seeds x {LONG_STEPS} steps in "
        f"{time.perf_counter() - t_start:.1f} s ({card}; GT budget "
        f"{gt_budget}); ms/step per seed {[round(r, 3) for r in rate]}; "
        f"launches {launches}")
    if nonfinite:
        raise RuntimeError(f"long parity: {nonfinite} non-finite steps")
    if misses:
        raise RuntimeError(f"long parity: outside the JAX envelope at "
                           f"{misses}")
    steps = LONG_STEPS * len(LONG_SEEDS)
    names = ("flat_composite_fwd", "flat_composite_bwd")
    if any(launches[k] < steps for k in names):
        raise RuntimeError(f"long parity: the path missed a kernel: "
                           f"{launches}")
    if any(launches[f"{k}_plain"] for k in names):
        raise RuntimeError(f"long parity: the path ran a plain version: "
                           f"{launches}")
    return launches


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
        from fusionsense_tpu_torch.render import preprocess as PP
        from fusionsense_tpu_torch.train import ssim_kernels as SK
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
    init_sharded = init.replace(
        **{k: v.clone() for k, v in init.fields().items()})
    tr = Trainer(cfg, cams, data, init, device=dev)
    torch.cuda.synchronize()
    log(f"scene: {time.perf_counter() - t0:.1f} s (GT budget {gt_budget}); "
        f"capacity {tr.gaussians.capacity}, render_n {tr.render_n}")

    # 3. K1/K2 against their plain versions, at the initial shapes; the
    # preprocess kernel pair against its plain version, and timed
    errs0, _ = check_kernels(torch, tr, tr.tile_capacity, tr.cover_tiles,
                             timed=False)
    pre_kernels = check_preprocess(torch, tr)
    ssim_kernels = check_ssim(torch, tr)

    # 4. the flat path (the preprocess pair once per step and view render,
    # the SSIM pair once per step)
    flat_names = ("flat_composite_fwd", "flat_composite_bwd")
    PP.reset_launch_counts()
    SK.reset_launch_counts()
    step0 = tr.step
    launches, ms_step, timed_shape = train_path(torch, tr, "flat", (FC, C2),
                                                flat_names)
    for k, key in zip(pre_kernels, ("fwd", "bwd")):
        k["launches"] = PP.LAUNCHES[f"preprocess_{key}"]
    if (min(k["launches"] for k in pre_kernels) < TRAIN_STEPS
            or PP.LAUNCHES["preprocess_plain"]):
        raise RuntimeError(f"flat: the main path missed the preprocess "
                           f"kernels: {PP.LAUNCHES}")
    for k, key in zip(ssim_kernels, ("fwd", "bwd")):
        k["launches"] = SK.LAUNCHES[f"ssim_{key}"]
    steps = tr.step - step0
    log(f"flat: SSIM launches {SK.LAUNCHES} over {steps} steps")
    if SK.LAUNCHES != {"ssim_fwd": steps, "ssim_bwd": steps, "ssim_plain": 0}:
        raise RuntimeError(f"flat: a step did not run the SSIM pair once: "
                           f"{SK.LAUNCHES} over {steps} steps")

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
    # 15. fs-touch on the pipeline's TSDF mesh and the resumed run's
    # high-grad cloud, with GLIP at full width (no kernel of K1-K4)
    touch_path(torch, dev, (FC, C2), card,
               SCRATCH / "pipeline" / "dn_splatter" / "mesh_tsdf.ply",
               SCRATCH / "pipeline" / "resume" / "high_grad_pts.pcd")
    # 16. the omnidata normal prior on the pipeline's capture (no K1-K4)
    omnidata_path(torch, dev, (FC, C2), card, SCRATCH / "blob")
    # 17. the live viewer: fs-train --viewer resumed from the pipeline's
    # last checkpoint (K3/K4 counted), then fs-viewer in subprocesses
    viewer_launches = viewer_path(
        torch, dev, (FC, C2), card, SCRATCH / "blob",
        SCRATCH / "pipeline" / "dn_splatter" / f"ckpt_{PIPE_ITERS}")
    for k, key in zip(fs_kernels, ("fwd", "bwd")):
        k["launches"] += viewer_launches[f"composite2_{key}"]
    # 18. the NeRF baseline on the pipeline's capture (no K1-K4)
    nerf_path(torch, dev, (FC, C2), card, SCRATCH / "blob")
    # 19. the sharded phase: K1-K4 at the blocks' global tiles, then 8 ranks
    # sharing the card: one step, the flat and dense ShardedTrainer, and
    # fs-train --device-mesh through torchrun
    shard_errs, shard_launches = sharded_path(torch, dev, card, cams, data,
                                              init_sharded, cfg)
    for k, key in zip(kernels + fs_kernels,
                      ("flat_composite_fwd", "flat_composite_bwd",
                       "composite2_fwd", "composite2_bwd")):
        k["launches"] += shard_launches[key]
        k["max_abs_err"] = max(k["max_abs_err"], shard_errs[key])

    # 20. the long-parity phase: the CPU harness's scene on the card, five
    # seeds of run_fused to step 4,000 held to the JAX float32 envelope
    long_launches = long_parity_path(torch, dev, (FC, C2), card)
    for k, key in zip(kernels, ("fwd", "bwd")):
        k["launches"] += long_launches[f"flat_composite_{key}"]

    # 21. results
    print(json.dumps({"kernels": kernels + fs_kernels + pre_kernels
                      + ssim_kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
