"""Gaussian-density queries: the K nearest Gaussians of each point and the
mixture density against them.

Counterpart of the first part of fusionsense_tpu/mesh/level_set.py
(`knn_indices`, `density_at`), which the SDF loss needs:
density(p) = sum_i o_i * exp(-1/2 (p - mu_i)^T Sigma_i^-1 (p - mu_i)) over
the K = 16 nearest Gaussians. The KNN is a chunked matmul + topk on the
device. The level-set surface extraction waits for the mesh port.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def knn_indices(points: torch.Tensor, refs: torch.Tensor,
                ref_valid: torch.Tensor, k: int = 16,
                chunk: int = 4096) -> torch.Tensor:
    """(P, 3) query points -> (P, k) indices of the nearest valid refs (N, 3).
    Indices carry no gradient."""
    ref_sq = torch.sum(refs * refs, -1)
    out = []
    for p in torch.split(points, chunk):
        d2 = (torch.sum(p * p, -1)[:, None] - 2.0 * (p @ refs.T)
              + ref_sq[None, :])
        d2 = torch.where(ref_valid[None, :], d2,
                         torch.full_like(d2, float("inf")))
        out.append(torch.topk(-d2, k, dim=-1).indices)
    return torch.cat(out, 0)


def density_at(points: torch.Tensor, knn_idx: torch.Tensor,
               means: torch.Tensor, icovs: torch.Tensor,
               opacities: torch.Tensor) -> torch.Tensor:
    """(P,) Gaussian-mixture density against each point's K nearest
    Gaussians (knn_idx (P, K))."""
    mu = means[knn_idx]                   # (P, K, 3)
    A = icovs[knn_idx]                    # (P, K, 3, 3)
    o = opacities[knn_idx]                # (P, K)
    d = points[:, None, :] - mu
    q = torch.einsum("pki,pkij,pkj->pk", d, A, d)
    return torch.sum(o * torch.exp(-0.5 * q), dim=-1)
