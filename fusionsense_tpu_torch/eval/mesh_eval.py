"""Mesh/point-cloud evaluation with optional visibility culling, plus
reference-pcd depth evaluation (the MuSHRoom faro-scanner protocol).

Counterpart of fusionsense_tpu/eval/mesh_eval.py (reference
dn_splatter/eval/eval_mesh*.py and data/mushroom_utils/eval_faro.py): the
sampling, visibility and depth culls are the same host numpy code; the
faro depth metrics go through this package's torch depth_metrics. Cameras
are the port's (tensors on any device); their values are read on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.device import host
from fusionsense_tpu_torch.eval.metrics import (
    chamfer_distance, depth_metrics, pd_metrics,
)


def _intrinsics(cameras: Camera):
    return (host(cameras.viewmat), host(cameras.fx), host(cameras.fy),
            host(cameras.cx), host(cameras.cy))


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray, n: int,
                       seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface samples (the trimesh.sample slot,
    reference scripts/VLM.py:93-130 uses 100k samples)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    p = area / max(area.sum(), 1e-12)
    rng = np.random.RandomState(seed)
    tri = rng.choice(len(faces), n, p=p)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return ((1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri]
            ).astype(np.float32)


def visible_mask(points: np.ndarray, cameras: Camera) -> np.ndarray:
    """True for points inside at least one camera frustum (in front, in
    image bounds) — the visibility-culling criterion."""
    vm, fx, fy, cx, cy = _intrinsics(cameras)
    W, H = cameras.width, cameras.height
    vis = np.zeros(len(points), bool)
    for i in range(vm.shape[0]):
        p = points @ vm[i, :3, :3].T + vm[i, :3, 3]
        z = p[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = p[:, 0] / z * fx[i] + cx[i]
            v = p[:, 1] / z * fy[i] + cy[i]
        vis |= (z > 1e-4) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return vis


def depth_cull_mask(
    points: np.ndarray,
    cameras: Camera,
    depths,                      # (V, H, W) observed z-depth, 0 = missing
    eps: float = 0.02,
    min_views: int = 1,
) -> np.ndarray:
    """Observability cull against depth maps — the go-surf criterion of the
    reference's mesh eval (eval_mesh_vis_cull.py:96-140 and :270-295): a
    point counts as OBSERVED in a view when it is inside the frustum and
    not occluded (its camera-space z is within eps in front of the view's
    depth at its pixel), and as INVALID when the view has no depth there.
    Keep points observed in >= min_views views and not invalid in >70% of
    their observations."""
    pts = np.asarray(points, np.float64)
    vm, fx, fy, cx, cy = _intrinsics(cameras)
    depths = host(depths)
    W, H = cameras.width, cameras.height
    obs = np.zeros(len(pts), np.int32)
    inv = np.zeros(len(pts), np.int32)
    for i in range(vm.shape[0]):
        p = pts @ vm[i, :3, :3].T + vm[i, :3, 3]
        z = p[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = p[:, 0] / z * float(fx[i]) + float(cx[i])
            v = p[:, 1] / z * float(fy[i]) + float(cy[i])
        in_f = (z > 1e-4) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        ui = np.clip(np.nan_to_num(u), 0, W - 1).astype(np.int32)
        vi = np.clip(np.nan_to_num(v), 0, H - 1).astype(np.int32)
        d = depths[i][vi, ui]
        obs += (in_f & (z < d + eps)).astype(np.int32)
        inv += (in_f & (d <= 0.0)).astype(np.int32)
    return (obs >= min_views) & ~(inv > 0.7 * np.maximum(obs, 1))


def mesh_eval(
    pred_verts: np.ndarray, pred_faces: np.ndarray,
    gt_points: np.ndarray,
    cameras: Camera | None = None,
    n_samples: int = 100_000,
    comp_threshold: float = 0.05,
) -> dict:
    """Chamfer + accuracy/completeness, reported raw and visibility-culled."""
    pred = sample_mesh_points(pred_verts, pred_faces,
                              min(n_samples, max(len(pred_faces) * 4, 1000)))
    out = {
        "chamfer_x1e3": chamfer_distance(pred, gt_points),
        **pd_metrics(pred, gt_points, comp_threshold),
    }
    if cameras is not None:
        keep_p = visible_mask(pred, cameras)
        keep_g = visible_mask(np.asarray(gt_points), cameras)
        if keep_p.any() and keep_g.any():
            out["culled_chamfer_x1e3"] = chamfer_distance(
                pred[keep_p], np.asarray(gt_points)[keep_g])
            culled_pd = pd_metrics(pred[keep_p],
                                   np.asarray(gt_points)[keep_g],
                                   comp_threshold)
            out.update({f"culled_{k}": v for k, v in culled_pd.items()})
    return out


def faro_depth_eval(
    render_depths,                 # (V, H, W) rendered z-depths
    ref_points: np.ndarray,        # registered reference (faro) point cloud
    cameras: Camera,
    tolerance: float = 0.1,
) -> dict:
    """Project the reference cloud into each view (nearest-hit z-buffer on
    the host) and run the depth metric battery against the renders, on the
    renders' device."""
    dev = (render_depths.device if torch.is_tensor(render_depths)
           else torch.device("cpu"))
    rd = host(render_depths)
    V = rd.shape[0]
    W, H = cameras.width, cameras.height
    vm, fx, fy, cx, cy = _intrinsics(cameras)
    agg = None
    for i in range(V):
        p = ref_points @ vm[i, :3, :3].T + vm[i, :3, 3]
        z = p[:, 2]
        ok = z > 1e-4
        u = np.clip((p[ok, 0] / z[ok] * float(fx[i])
                     + float(cx[i])).astype(np.int64), 0, W - 1)
        v = np.clip((p[ok, 1] / z[ok] * float(fy[i])
                     + float(cy[i])).astype(np.int64), 0, H - 1)
        gt = np.full((H, W), np.inf, np.float32)
        np.minimum.at(gt, (v, u), z[ok].astype(np.float32))
        gt = np.where(np.isfinite(gt), gt, 0.0)
        # compare only where BOTH the render and the reference have depth
        gt = np.where(rd[i] > tolerance, gt, 0.0)
        m = depth_metrics(torch.as_tensor(rd[i], device=dev),
                          torch.as_tensor(gt, dtype=torch.float32,
                                          device=dev), tolerance)
        m = {k: float(val) for k, val in m.items()}
        agg = m if agg is None else {k: agg[k] + m[k] for k in m}
    return {k: v / V for k, v in agg.items()}
