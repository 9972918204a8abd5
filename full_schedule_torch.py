"""Full-schedule quality run of the PyTorch/H100 port: the reference's
15,000-step recipe end to end on the bench scene, then the TSDF mesh and
its chamfers.

    python3 full_schedule_torch.py                        # on the card
    python3 full_schedule_torch.py --device cpu --smoke   # every phase, toy size

The port of tools/full_schedule_run.py (which stays the JAX package's). The
recipe (reference configs/config.py:3-7 and scripts/train.py:274-327):
15,000 iterations, stop-split at 10,000, touch-patch anchoring at step
1,000, binary opacities, opacity resets every reset_alpha_every x
refine_every = 3,000 steps (at 3,500, 6,500 and 9,500 after warmup 500).
The scene is bench.py's (bench_torch.build_scene): 9 ring views at 640x480,
60,000 GT points, a 30,000-point perturbed initial state at capacity 2^17,
the flat backend (K1/K2) at tile 32. Trainer.run takes the steps, so the
touch callback anchors 4 synthetic patches at the first boundary past step
1,000 and prunes intruders at every later one.

Then, as the JAX script: the trained model's ED depth per view (alpha >
0.5), TSDF fusion at voxel 0.008 over a 160^3 grid (min_weight 2), the
marching-tetrahedra mesh, chamfer_eval against 20,000 analytic sphere
points, the seen-region chamfer (both clouds culled by depth_cull_mask
against the sensor depths) and the local chamfer at the 4 touch sites
(radius 0.08). Prints one JSON object (the card's name and power limit
in it) and writes it to build/full_schedule_torch.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FULL = dict(width=640, height=480, tile=32, n_views=9, n_seed=60_000,
            capacity=1 << 17, iters=15_000, chunk=50, log_every=100,
            touch_at=1000, adc={}, tsdf_res=160, n_gt=20_000)
# every phase at a toy size: numbers meaningless, the code paths all run
# (1,500 initial points, so that the trainer's capacity bucket holds the
# 1,600 touch-patch points it anchors)
SMOKE = dict(width=64, height=48, tile=16, n_views=3, n_seed=3000,
             capacity=1 << 12, iters=12, chunk=2, log_every=2, touch_at=4,
             adc=dict(warmup=2, refine_every=2, reset_alpha_every=2,
                      stop_split_at=8), tsdf_res=24, n_gt=500)


def _card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="every phase at a toy size (numbers meaningless)")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "full_schedule_torch.json"))
    args = ap.parse_args(argv)
    S = SMOKE if args.smoke else FULL

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from bench_torch import build_scene
    from fusionsense_tpu_torch.config import (
        ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
    )
    from fusionsense_tpu_torch.data.synthetic import (
        sphere_gt, sphere_points, sphere_touch_patches,
    )
    from fusionsense_tpu_torch.device import resolve_device
    from fusionsense_tpu_torch.eval.chamfer import chamfer_eval, local_chamfer
    from fusionsense_tpu_torch.eval.evaluator import make_render_fn
    from fusionsense_tpu_torch.eval.mesh_eval import depth_cull_mask
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig
    from fusionsense_tpu_torch.gaussians.init import init_from_points
    from fusionsense_tpu_torch.gaussians.touch import (
        add_touch_patches, touch_prune,
    )
    from fusionsense_tpu_torch.mesh.tsdf import (
        TSDFConfig, extract_mesh, fuse_depths,
    )
    from fusionsense_tpu_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        from fusionsense_tpu_torch.kernels.build import build_all

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build_all()
    rcfg, cams, data = build_scene(S, dev)
    pts, rgb, nrm = sphere_points(n=S["n_seed"] // 2, radius=0.5, seed=1,
                                  device=dev)
    noise = 0.02 * np.random.RandomState(0).randn(*pts.shape).astype(
        np.float32)
    init = init_from_points(pts + torch.as_tensor(noise, device=dev),
                            torch.full_like(rgb, 0.5),
                            capacity=S["capacity"], sh_degree=3,
                            seed_normals=nrm)
    cfg = ExperimentConfig(
        model=ModelConfig(sh_degree=3, rasterize=rcfg, capacity=S["capacity"],
                          binary_opacities=True),
        train=TrainConfig(iterations=S["iters"], scan_chunk=S["chunk"],
                          adc=ADCConfig(**S["adc"]),
                          add_touch_at=S["touch_at"],
                          log_every=S["log_every"]),
        loss=LossConfig())

    patches = sphere_touch_patches()
    state = {"boxes": None}

    def touch_cb(tr):
        if state["boxes"] is None and tr.step >= cfg.train.add_touch_at:
            # gel_scale ~ the synthetic caps' point spacing (400 points over
            # an 8-degree cap on the r = 0.5 sphere)
            tr.gaussians, tr.opt, state["boxes"] = add_touch_patches(
                tr.gaussians, tr.opt, patches, gel_scale=0.006)
            state["step"] = tr.step
            return True
        if state["boxes"] is not None:
            tr.gaussians = touch_prune(tr.gaussians, state["boxes"])
        return False

    tr = Trainer(cfg, cams, data, init, extra_callbacks=[touch_cb],
                 device=dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(log=print)
    if cuda:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    # the TSDF mesh and its chamfers against the analytic sphere
    render = make_render_fn(
        dataclasses.replace(rcfg, tile_capacity=tr.tile_capacity), cams)
    outs = [render(tr.gaussians, i) for i in range(S["n_views"])]
    # ED depth gated to confidently covered pixels, as mesh_export does
    depths = torch.stack([torch.where(o.alpha > 0.5, o.depth,
                                      torch.zeros_like(o.depth))
                          for o in outs])
    # min_weight 2 as mesh_export's _auto_tsdf_cfg: a 9-view ring sees the
    # equator's voxels from only 2-4 views within the truncation
    res = S["tsdf_res"]
    voxel = 1.28 / res
    tcfg = TSDFConfig(voxel_size=voxel, truncation=3 * voxel,
                      resolution=(res,) * 3, origin=(-0.64, -0.64, -0.64),
                      min_weight=2.0)
    t1 = time.perf_counter()
    tsdf, weight = fuse_depths(depths, cams, tcfg)
    verts, _ = extract_mesh(tsdf, weight, tcfg)
    if cuda:
        torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t1
    gt_pts = sphere_gt(S["n_gt"])
    cham = chamfer_eval(verts, gt_pts)
    # the reference protocol's cull: both clouds to the region the capture
    # observes (eval_mesh_vis_cull.py); the ring never sees the bottom cap
    keep_p = depth_cull_mask(verts, cams, data.sensor_depths)
    keep_g = depth_cull_mask(gt_pts, cams, data.sensor_depths)
    cham_seen = chamfer_eval(verts[keep_p], gt_pts[keep_g])
    sites = np.stack([p.bbox_center for p in patches])
    loc = local_chamfer(verts, gt_pts, sites, radius=0.08)

    def _j(v):  # NaN -> null: keep the artifact strict JSON
        return None if isinstance(v, float) and not np.isfinite(v) else v

    by_step = {h["step"]: h for h in tr.history}
    at_3000 = max((s for s in by_step if s <= 3000), default=None)
    out = {
        "device": {"name": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "card": _card() if cuda else None},
        "smoke": bool(args.smoke),
        "schedule": {"iterations": S["iters"],
                     "stop_split_at": cfg.train.adc.stop_split_at,
                     "add_touch_at": cfg.train.add_touch_at,
                     "binary_opacities": True, "touch_anchored_at":
                     state.get("step")},
        "wall_clock_s": wall_s,
        "ms_per_step": 1e3 * wall_s / S["iters"],
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9 if cuda
                    else None),
        "psnr_at_3000": (by_step[at_3000]["psnr"] if at_3000 is not None
                         else None),
        "psnr_3000_step": at_3000,
        "final_psnr": tr.history[-1]["psnr"],
        "final_alive": int(tr.gaussians.num_alive),
        "mesh_s": mesh_s,
        "mesh_verts": int(len(verts)),
        "chamfer_x1e3": cham["chamfer_x1e3"],
        "chamfer_seen_x1e3": cham_seen["chamfer_x1e3"],
        "gt_seen_frac": float(keep_g.mean()),
        "local_chamfer_x1e3": [_j(v) for v in loc],
        "gaussian_trajectory": [
            {"step": h["step"], "psnr": h["psnr"], "n": h["num_gaussians"]}
            for h in tr.history if h["step"] % 500 == 0],
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, allow_nan=False))
    print(json.dumps({k: v for k, v in out.items()
                      if k != "gaussian_trajectory"}, allow_nan=False))
    return out


if __name__ == "__main__":
    main()
