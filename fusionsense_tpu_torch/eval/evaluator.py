"""Whole-split evaluation: render every view, average the metric battery.

Counterpart of fusionsense_tpu/eval/evaluator.py: per-view PSNR / SSIM /
masked PSNR (LPIPS when a backend is available), depth and normal metrics,
their means, and the render throughput (fps, Mpix/s) timed over steady-state
renders that end in a device synchronisation.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.core.transforms import apply_se3_delta
from fusionsense_tpu_torch.eval import lpips as _lpips
from fusionsense_tpu_torch.eval import metrics as M
from fusionsense_tpu_torch.gaussians.store import GaussianState, activated
from fusionsense_tpu_torch.render.rasterize import (
    RasterizeConfig, gaussian_flat_normals, rasterize,
)

MAX_RENDER_PAIR_BUDGET = 16384


def make_render_fn(cfg: RasterizeConfig, camera: Camera, cam_deltas=None,
                   max_budget: int = MAX_RENDER_PAIR_BUDGET):
    """View renderer: (gaussians, cam_idx) -> RenderOutputs, without grad.

    cam_deltas: optional (V, 6) SE3 pose corrections from the trainer's
    camera optimiser, applied as in training, so eval on train views uses
    the optimised poses.

    Flat backend: the pair budget doubles on overflow, up to max_budget, and
    the grown budget stays for later views (the overflow check reads one
    scalar per render on the host, which is why this stays off the step)."""
    def render_with(rcfg, gaussians: GaussianState, cam_idx):
        with torch.no_grad():
            means, quats, scales, op, colors = activated(gaussians)
            cam_i = camera.index(cam_idx)
            if cam_deltas is not None:
                cam_i = cam_i.replace(viewmat=apply_se3_delta(
                    cam_i.viewmat, cam_deltas[cam_idx]))
            normals = gaussian_flat_normals(quats, scales, means, cam_i.origin)
            return rasterize(means, quats, scales, op, colors, cam_i, rcfg,
                             normals=normals, device=means.device)

    if cfg.backend != "flat":
        return lambda gaussians, cam_idx: render_with(cfg, gaussians, cam_idx)

    state = {"cfg": cfg}

    def render_retry(gaussians: GaussianState, cam_idx):
        out = render_with(state["cfg"], gaussians, cam_idx)
        while (int(out.overflow) > 0
               and state["cfg"].tile_capacity < max_budget):
            state["cfg"] = dataclasses.replace(
                cfg, tile_capacity=min(state["cfg"].tile_capacity * 2,
                                       max_budget))
            out = render_with(state["cfg"], gaussians, cam_idx)
        return out

    return render_retry


def view_psnrs(gaussians: GaussianState, camera: Camera, images: torch.Tensor,
               cfg: RasterizeConfig) -> list[float]:
    """The PSNR of every view of `images` (V, H, W, 3), each rendered from
    `gaussians` through make_render_fn (the flat pair budget grows on
    overflow); their mean is the quality metric of bench_torch.py and of
    the long-run parity checks."""
    render = make_render_fn(cfg, camera)
    return [float(M.psnr(render(gaussians, i).rgb, images[i]))
            for i in range(images.shape[0])]


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate(gaussians: GaussianState, camera: Camera, data, cfg: RasterizeConfig,
             measure_fps: bool = True, cam_deltas=None) -> dict:
    """Render each view of `data` (a TrainData of the eval split) -> {"mean":
    the metrics averaged over views, with fps, mpix_per_s and num_gaussians;
    "per_view": [...]}."""
    render = make_render_fn(cfg, camera, cam_deltas=cam_deltas)
    V = data.images.shape[0]
    use_lpips = _lpips.available()
    per_view = []
    for i in range(V):
        out = render(gaussians, i)
        m = M.rgb_metrics(out.rgb, data.images[i],
                          None if data.masks is None else data.masks[i])
        if use_lpips:
            m["lpips"] = _lpips.lpips(out.rgb, data.images[i])
        if data.sensor_depths is not None:
            dm = None if data.masks is None else data.masks[i]
            m.update({f"depth_{k}": v for k, v in M.depth_metrics(
                out.depth, data.sensor_depths[i], mask=dm).items()})
        if data.normals is not None:
            mask = data.masks[i] if data.masks is not None else (
                data.sensor_depths[i] > 1e-4 if data.sensor_depths is not None
                else None)
            m.update({f"normal_{k}": v for k, v in M.normal_metrics(
                out.normal, data.normals[i], mask).items()})
        per_view.append({k: float(v) for k, v in m.items()})

    agg = {k: float(np.mean([pv[k] for pv in per_view])) for k in per_view[0]}
    if measure_fps:
        dev = gaussians.device
        _sync(dev)
        t0 = time.perf_counter()
        reps = max(3, min(10, V))
        for i in range(reps):
            render(gaussians, i % V)
        _sync(dev)
        dt = (time.perf_counter() - t0) / reps
        agg["fps"] = 1.0 / dt
        agg["mpix_per_s"] = camera.width * camera.height / dt / 1e6
    agg["num_gaussians"] = int(gaussians.num_alive)
    return {"mean": agg, "per_view": per_view}
