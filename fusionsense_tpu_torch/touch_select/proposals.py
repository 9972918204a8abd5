"""Next-best-touch proposal ranking.

The port's copy of fusionsense_tpu/touch_select/proposals.py (numpy and
scipy).

Behavioral spec from the reference (reference scripts/VLM.py:228-312):
- fuse part-segmentation ranks onto the high-gradient point cloud by
  1-nearest-neighbor (fuse_gaussian_and_segmentation, :228-255),
- propose: sort candidate points by (part_rank, grad_rank); take
  `per_part` points from each of the top 60% parts, then fill to the quota
  from the remaining ranking (propose_next_best_touch, :257-312).

The reference's O(N*M) python NN loop becomes a cKDTree query.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TouchProposals:
    points: np.ndarray        # (Q, 3) proposed touch points
    part_rank: np.ndarray     # (Q,)
    grad_rank: np.ndarray     # (Q,)


def fuse_part_ranks(
    high_grad_points: np.ndarray,      # (N, 3)
    seg_points: np.ndarray,            # (M, 3) part-segmented cloud
    seg_part_rank: np.ndarray,         # (M,) int rank per point (0 best)
    max_dist: float | None = None,
) -> np.ndarray:
    """1-NN semantic rank for each high-grad point; unmatched -> max+1."""
    from scipy.spatial import cKDTree

    if len(seg_points) == 0 or len(high_grad_points) == 0:
        return np.full(len(high_grad_points),
                       (seg_part_rank.max() + 1) if len(seg_part_rank) else 0,
                       np.int64)
    d, idx = cKDTree(seg_points).query(high_grad_points)
    ranks = seg_part_rank[idx].astype(np.int64)
    if max_dist is not None:
        ranks = np.where(d <= max_dist, ranks, seg_part_rank.max() + 1)
    return ranks


def propose_touches(
    points: np.ndarray,                # (N, 3) candidates (high-grad cloud)
    part_rank: np.ndarray,             # (N,)
    grad_rank: np.ndarray,             # (N,)
    quota: int = 10,
    per_part: int = 5,
    top_part_fraction: float = 0.6,
    min_spacing: float = 0.0,
) -> TouchProposals:
    """Rank candidates and select the touch set."""
    if len(points) == 0:
        z = np.zeros(0)
        return TouchProposals(points.reshape(0, 3), z, z)
    order = np.lexsort((grad_rank, part_rank))   # primary: part, tie: grad
    pts, pr, gr = points[order], part_rank[order], grad_rank[order]

    n_parts = int(pr.max()) + 1
    top_parts = max(1, int(np.ceil(n_parts * top_part_fraction)))
    chosen: list[int] = []

    def far_enough(i):
        if min_spacing <= 0 or not chosen:
            return True
        d = np.linalg.norm(pts[chosen] - pts[i], axis=-1)
        return bool(d.min() >= min_spacing)

    for part in range(top_parts):
        count = 0
        for i in np.nonzero(pr == part)[0]:
            if count >= per_part or len(chosen) >= quota:
                break
            if far_enough(i):
                chosen.append(int(i))
                count += 1
    for i in range(len(pts)):                     # fill to quota
        if len(chosen) >= quota:
            break
        if i not in chosen and far_enough(i):
            chosen.append(int(i))

    chosen = np.asarray(chosen[:quota], np.int64)
    return TouchProposals(points=pts[chosen], part_rank=pr[chosen],
                          grad_rank=gr[chosen])
