"""High-gradient Gaussian export: the "visually uncertain regions" signal.

Counterpart of fusionsense_tpu/touch_select/high_grad.py:
- select the alive Gaussians whose mean accumulated screen gradient is at or
  above the 90th percentile (np.percentile's linear rule) and that lie
  within 0.01 * scene scale of the visual hull,
- cluster them with DBSCAN(eps=0.01, min_samples=15) and rank the clusters
  by mean gradient (rank 0 = most uncertain); noise points are dropped,
- write high_grad_pts.pcd in capture coordinates with per-point grad,
  cluster and grad_rank fields.
DBSCAN is the port's own, on scipy's cKDTree, with scikit-learn's labels
(see `dbscan`). It runs once per training run, on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from fusionsense_tpu_torch.gaussians.adc import RefineStats
from fusionsense_tpu_torch.gaussians.store import GaussianState
from fusionsense_tpu_torch.utils.ply import write_pcd


@dataclasses.dataclass(frozen=True)
class HighGradConfig:
    grad_percentile: float = 90.0     # "high" = above this percentile
    hull_dist_max: float = 0.01       # x scene scale
    dbscan_eps: float = 0.01
    dbscan_min_samples: int = 15


def dbscan(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN labels (-1 = noise) equal to sklearn.cluster.DBSCAN's
    fit_predict with the Euclidean metric: neighbourhoods are the points
    within eps, the point itself included; a point is core when its
    neighbourhood holds at least min_samples points; clusters grow
    depth-first from the core points in index order (sklearn's
    dbscan_inner), so a border point takes the label of the first cluster
    that reaches it."""
    from scipy.spatial import cKDTree

    n = len(points)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    neighbors = cKDTree(points).query_ball_point(points, eps)
    core = np.array([len(nb) >= min_samples for nb in neighbors])
    label = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = []
        while True:
            if labels[i] == -1:
                labels[i] = label
                if core[i]:
                    stack.extend(v for v in neighbors[i] if labels[v] == -1)
            if not stack:
                break
            i = stack.pop()
        label += 1
    return labels


def select_high_grad_points(state: GaussianState, stats: RefineStats,
                            hull_points: np.ndarray | None,
                            scene_scale: float = 1.0,
                            cfg: HighGradConfig = HighGradConfig()):
    """Returns (points (M, 3) scene coords, grads (M,)) of uncertain
    regions, as host float32."""
    alive = state.alive.cpu().numpy()
    count = stats.count.cpu().numpy()
    grads = stats.grad2d_acc.cpu().numpy() / np.maximum(count, 1)
    means = state.means.detach().cpu().numpy()

    cand = alive & (count > 0)
    if not cand.any():
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    thresh = np.percentile(grads[cand], cfg.grad_percentile)
    high = cand & (grads >= thresh)
    idx = np.nonzero(high)[0]
    if hull_points is not None and len(hull_points):
        from scipy.spatial import cKDTree

        d, _ = cKDTree(np.asarray(hull_points)).query(means[high])
        idx = idx[d < cfg.hull_dist_max * scene_scale]
    return means[idx].astype(np.float32), grads[idx].astype(np.float32)


def cluster_and_rank(points: np.ndarray, grads: np.ndarray,
                     cfg: HighGradConfig = HighGradConfig()):
    """DBSCAN-cluster the uncertain points and rank the clusters by mean
    grad. Returns (points, grads, labels, ranks) without the noise points;
    rank 0 is the highest mean gradient."""
    if len(points) == 0:
        return points, grads, np.zeros(0, np.int64), np.zeros(0, np.int64)
    labels = dbscan(points, cfg.dbscan_eps, cfg.dbscan_min_samples)
    keep = labels >= 0
    points, grads, labels = points[keep], grads[keep], labels[keep]
    if len(points) == 0:
        return points, grads, labels, np.zeros(0, np.int64)
    cluster_ids = np.unique(labels)
    mean_grads = np.array([grads[labels == c].mean() for c in cluster_ids])
    order = np.argsort(-mean_grads)            # descending
    rank_of = {int(cluster_ids[o]): r for r, o in enumerate(order)}
    ranks = np.array([rank_of[int(c)] for c in labels], np.int64)
    return points, grads, labels, ranks


def export_high_grad_pcd(path, state: GaussianState, stats: RefineStats,
                         hull_points: np.ndarray | None, untransform=None,
                         scene_scale: float = 1.0,
                         cfg: HighGradConfig = HighGradConfig()) -> int:
    """Select -> cluster -> rank -> write the .pcd. Returns the count."""
    pts, grads = select_high_grad_points(state, stats, hull_points,
                                         scene_scale, cfg)
    pts, grads, labels, ranks = cluster_and_rank(pts, grads, cfg)
    if untransform is not None and len(pts):
        pts = untransform(pts)
    write_pcd(path, pts, extra={
        "grad": grads, "cluster": labels.astype(np.float32),
        "grad_rank": ranks.astype(np.float32)})
    return len(pts)
