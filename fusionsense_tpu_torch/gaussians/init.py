"""Seed-point-cloud initialization of the Gaussian store.

Counterpart of fusionsense_tpu/gaussians/init.py: SH0 from RGB, scales from
the mean distance of the 3 nearest neighbours, z squashed to a flat disc and
+z rotated onto the seed normal when seed normals are given.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from fusionsense_tpu_torch.core.sh import rgb_to_sh0
from fusionsense_tpu_torch.core.transforms import (
    normalize, random_quats, rotation_between,
)
from fusionsense_tpu_torch.gaussians.store import GaussianState, new_state


def knn_mean_dist(points: torch.Tensor, k: int = 3,
                  chunk: int = 4096) -> torch.Tensor:
    """(N, 3) -> (N,) mean distance to the k nearest neighbours (excl. self),
    one (chunk, N) distance block at a time."""
    n_orig = points.shape[0]
    pad = (-n_orig) % chunk
    if pad:  # far-away sentinels never enter anyone's top-k
        points = torch.cat(
            [points, torch.full((pad, 3), 1e6, dtype=points.dtype,
                                device=points.device)], 0)
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    cols = torch.arange(n, device=points.device)
    out = []
    for start in range(0, n, chunk):
        p = points[start:start + chunk]
        d2 = sq[start:start + chunk, None] - 2.0 * (p @ points.T) + sq[None, :]
        d2 = torch.where(cols[start:start + chunk, None] == cols[None, :],
                         torch.full_like(d2, math.inf), d2)
        near = torch.topk(d2, k, dim=-1, largest=False).values
        out.append(torch.mean(torch.sqrt(torch.clamp_min(near, 1e-12)), dim=-1))
    return torch.cat(out)[:n_orig]


def init_from_points(
    points: torch.Tensor,                    # (N, 3)
    rgb: torch.Tensor,                       # (N, 3) in [0, 1]
    *,
    capacity: int,
    sh_degree: int = 3,
    seed_normals: Optional[torch.Tensor] = None,
    init_opacity: float = 0.1,
    flat_z_ratio: float = 0.1,
    generator: Optional[torch.Generator] = None,
) -> GaussianState:
    """A store of `capacity` slots whose first N hold the seed points. Runs
    on the points' device; without seed normals the orientations come from
    `generator` (a torch stream, not the JAX package's)."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"seed points {n} exceed capacity {capacity}")
    dev = points.device
    state = new_state(capacity, sh_degree, device=dev)

    dist = knn_mean_dist(points)
    scales = dist[:, None].repeat(1, 3)
    if seed_normals is not None:
        scales = torch.cat([scales[:, :2], scales[:, 2:] * flat_z_ratio], 1)
        ez = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3)
        quats = rotation_between(ez, normalize(seed_normals))
        normals = normalize(seed_normals)
    else:
        quats = random_quats(n, generator, device=dev)
        normals = torch.zeros((n, 3), device=dev)
        normals[:, 2] = 1.0

    logit_op = math.log(init_opacity / (1.0 - init_opacity))
    state.means[:n] = points
    state.quats[:n] = quats
    state.log_scales[:n] = torch.log(torch.clamp_min(scales, 1e-8))
    state.logit_opacities[:n] = logit_op
    state.features_dc[:n] = rgb_to_sh0(rgb)
    state.normals[:n] = normals
    state.alive[:n] = True
    return state
