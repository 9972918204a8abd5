"""Mesh-vs-CAD chamfer evaluation with ICP alignment (host numpy/scipy).

A copy of fusionsense_tpu/eval/chamfer.py: the same host numpy and scipy
code, so the same inputs give the JAX package's numbers.

Behavioral equivalent of the reference's chamfer eval
(reference eval_utils/chamfer_evaluation.py:10-150): align the extracted
level-set point cloud to a CAD ground truth (mm -> m), then report the
symmetric squared chamfer distance x 1e3. The reference uses FPFH+RANSAC
global registration (chamfer_evaluation.py:117-137) + point-to-plane ICP
via open3d; here (no open3d): a trimmed-score ROTATION SEARCH over an
SO(3) candidate grid for the global init — serving the same role as
FPFH+RANSAC (escape the wrong ICP basin on symmetric/rotated inputs) —
followed by point-to-point trimmed ICP (SVD).

Also implements the reference's per-touch-site local chamfer
(chamfer_evaluation.py:82-114 local_CD/touch_CD_eval).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from fusionsense_tpu_torch.eval.metrics import chamfer_distance


def _so3_candidates(n_random: int = 40, seed: int = 0) -> np.ndarray:
    """(K, 3, 3) rotation candidates: the 24-element octahedral group
    (covers all axis-permutation/flip misalignments exactly) + random
    quaternions filling the rest of SO(3) to ~40 deg granularity."""
    mats = []
    # octahedral rotation group: signed permutation matrices with det +1
    from itertools import permutations, product

    for perm in permutations(range(3)):
        for signs in product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3))
            for i, (j, s) in enumerate(zip(perm, signs)):
                R[i, j] = s
            if np.linalg.det(R) > 0.5:
                mats.append(R)
    rng = np.random.RandomState(seed)
    q = rng.randn(n_random, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)
    return np.concatenate([np.stack(mats), R], axis=0)


def global_rotation_init(
    src: np.ndarray, dst: np.ndarray,
    subsample: int = 1500, trim: float = 0.7, seed: int = 0,
) -> np.ndarray:
    """Best candidate rotation (applied about the centroids) by trimmed
    nearest-neighbor score — the FPFH+RANSAC stand-in. Returns (3, 3)."""
    rng = np.random.RandomState(seed)

    def sub(x):
        return (x[rng.choice(len(x), subsample, replace=False)]
                if len(x) > subsample else x)

    s = sub(np.asarray(src, np.float64))
    d = sub(np.asarray(dst, np.float64))
    sc = s - s.mean(0)
    mu_d = d.mean(0)
    tree = cKDTree(d)
    best_R, best_score = np.eye(3), np.inf
    for R in _so3_candidates(seed=seed):
        cand = sc @ R.T + mu_d
        dist, _ = tree.query(cand)
        score = np.mean(np.sort(dist)[: int(trim * len(dist))])
        if score < best_score:
            best_score, best_R = score, R
    return best_R


def _umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform src -> dst (Umeyama)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    scale = (np.trace(np.diag(D) @ S) / np.mean(np.sum(xs ** 2, -1))
             if with_scale else 1.0)
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def icp_align(
    src: np.ndarray, dst: np.ndarray,
    iterations: int = 50, trim: float = 0.8, with_scale: bool = False,
    init_scale_from_extent: bool = True, global_init: bool = True,
):
    """Trimmed point-to-point ICP. Returns (aligned_src, (s, R, t)).

    global_init=True prepends the rotation-search registration (the
    reference's FPFH+RANSAC stage, chamfer_evaluation.py:117-137):
    trimmed ICP alone needs a roughly-aligned start and can silently
    converge to a wrong basin on rotated/symmetric objects."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)

    # global init: match centroids (+ optional RMS extent scale)
    s0 = 1.0
    if init_scale_from_extent:
        rs = np.sqrt(np.mean(np.sum((src - src.mean(0)) ** 2, -1)))
        rd = np.sqrt(np.mean(np.sum((dst - dst.mean(0)) ** 2, -1)))
        s0 = rd / max(rs, 1e-12)
    R0 = np.eye(3)
    if global_init:
        R0 = global_rotation_init(
            (src - src.mean(0)) * s0, dst - dst.mean(0))
    cur = (src - src.mean(0)) * s0 @ R0.T + dst.mean(0)
    total_s = s0
    total_R = R0
    total_t = dst.mean(0) - s0 * R0 @ src.mean(0)

    tree = cKDTree(dst)
    for _ in range(iterations):
        d, idx = tree.query(cur)
        keep = d <= np.quantile(d, trim)
        s, R, t = _umeyama(cur[keep], dst[idx[keep]], with_scale)
        cur = (s * (R @ cur.T)).T + t
        total_R = R @ total_R
        total_s = s * total_s
        total_t = s * R @ total_t + t
    return cur, (total_s, total_R, total_t)


def local_chamfer(
    pred: np.ndarray, gt: np.ndarray, centers: np.ndarray,
    radius: float = 0.01, mode: str = "at_site",
) -> list[float]:
    """Per-touch-site chamfer x 1e3 (reference local_CD/touch_CD_eval,
    chamfer_evaluation.py:82-114).

    mode="at_site" restricts BOTH clouds to points within `radius` of the
    touch center — local reconstruction quality where the tactile patch
    was anchored (the metric's stated purpose). mode="exclude_site"
    replicates the reference code's literal filter (it keeps points
    FARTHER than radius, chamfer_evaluation.py:86-93 `distances > radius`
    on both clouds — chamfer with the site removed)."""
    out = []
    for c in np.atleast_2d(np.asarray(centers, np.float64)):
        dp = np.linalg.norm(pred - c, axis=1)
        dg = np.linalg.norm(gt - c, axis=1)
        if mode == "exclude_site":
            p, g = pred[dp > radius], gt[dg > radius]
        else:
            p, g = pred[dp <= radius], gt[dg <= radius]
        if len(p) < 2 or len(g) < 2:
            out.append(float("nan"))
            continue
        out.append(chamfer_distance(p, g))
    return out


def chamfer_eval(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    gt_unit_scale: float = 1.0,   # e.g. 1e-3 for a CAD file in mm
    sample: int = 100_000,
    seed: int = 0,
    touch_centers: np.ndarray | None = None,
    touch_radius: float = 0.01,
) -> dict:
    """Globally register + ICP-align prediction to GT, report chamfer x 1e3
    (+ per-touch-site local chamfer when touch_centers are given, in the
    GT/world frame after alignment)."""
    rng = np.random.RandomState(seed)
    gt = np.asarray(gt_points, np.float64) * gt_unit_scale
    pred = np.asarray(pred_points, np.float64)
    if len(pred) > sample:
        pred = pred[rng.choice(len(pred), sample, replace=False)]
    if len(gt) > sample:
        gt = gt[rng.choice(len(gt), sample, replace=False)]
    aligned, transform = icp_align(pred, gt, with_scale=False)
    res = {
        "chamfer_x1e3": chamfer_distance(aligned, gt),
        "transform_scale": float(transform[0]),
    }
    if touch_centers is not None and len(touch_centers):
        s, R, t = transform
        centers = (s * (R @ np.atleast_2d(
            np.asarray(touch_centers, np.float64)).T)).T + t
        local = local_chamfer(aligned, gt, centers, radius=touch_radius)
        res["local_chamfer_x1e3"] = local
        finite = [v for v in local if np.isfinite(v)]
        res["local_chamfer_x1e3_mean"] = (float(np.mean(finite))
                                          if finite else float("nan"))
    return res
