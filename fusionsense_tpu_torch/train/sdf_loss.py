"""SuGaR-style SDF regularisation (optional loss, `sdf_lambda > 0`).

Counterpart of fusionsense_tpu/train/sdf_loss.py:
- sample points inside Gaussians, volume-weighted
  (`sample_points_in_gaussians`, drawn from an explicit torch.Generator),
- mixture density d(p) against the K nearest Gaussians; sdf = sqrt(-2 log d),
- the "ideal" sdf from the rendered depth: project each sample into the
  camera and compare its camera depth with the rendered depth at its pixel,
- loss = mean |sdf - |ideal sdf|| over the valid samples.
The draw is apart from the loss, so a caller can feed samples drawn
elsewhere. Samples and the ideal sdf carry no gradient; the density carries
gradients to means, quats, scales and opacities.
"""
from __future__ import annotations

import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.core.transforms import (
    quat_scale_to_inv_cov3d, quat_to_rotmat,
)
from fusionsense_tpu_torch.mesh.level_set import density_at, knn_indices


@torch.no_grad()
def sample_points_in_gaussians(generator: torch.Generator,
                               means: torch.Tensor, quats: torch.Tensor,
                               scales: torch.Tensor, alive: torch.Tensor,
                               n_samples: int):
    """Volume-weighted samples: pick Gaussians in proportion to their volume,
    then draw from each -> (points (S, 3), idx (S,))."""
    vol = torch.where(alive, torch.prod(scales, dim=-1),
                      torch.zeros_like(scales[:, 0]))
    p = vol / torch.clamp_min(torch.sum(vol), 1e-12)
    # the JAX categorical over log(max(p, 1e-20)): dead slots keep a
    # vanishing weight, so an all-dead store still draws
    idx = torch.multinomial(torch.clamp_min(p, 1e-20), n_samples,
                            replacement=True, generator=generator)
    local = torch.randn((n_samples, 3), generator=generator,
                        device=means.device) * scales[idx]
    R = quat_to_rotmat(quats[idx])
    return means[idx] + torch.einsum("nij,nj->ni", R, local), idx


def sdf_from_density(density: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """sdf = sqrt(-2 log d), with d clamped to [eps, 1 - 1e-6]."""
    d = torch.clamp(density, eps, 1.0 - 1e-6)
    return torch.sqrt(-2.0 * torch.log(d))


def ideal_sdf_from_depth(points: torch.Tensor, depth: torch.Tensor,
                         camera: Camera):
    """Signed distance estimate from the rendered z-depth along each
    sample's pixel ray -> (ideal_sdf (S,), valid (S,))."""
    p_cam = points @ camera.viewmat[:3, :3].T + camera.viewmat[:3, 3]
    z = p_cam[:, 2]
    zc = torch.clamp_min(z, 1e-6)
    u = p_cam[:, 0] / zc * camera.fx + camera.cx
    v = p_cam[:, 1] / zc * camera.fy + camera.cy
    H, W = depth.shape
    # float -> int truncates toward zero, as jnp's astype does
    ui = torch.clamp(u.to(torch.int32), 0, W - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, H - 1).long()
    d = depth[vi, ui]
    valid = ((z > 1e-4) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
             & (d > 1e-4))
    return d - z, valid


def sdf_loss(points: torch.Tensor, means, quats, scales, opacities, alive,
             depth: torch.Tensor, camera: Camera, knn: int = 16) -> torch.Tensor:
    """|mixture sdf - |ideal sdf|| over the samples `points` (S, 3)."""
    pts = points.detach()
    icovs = quat_scale_to_inv_cov3d(quats, scales)
    op = torch.where(alive, opacities, torch.zeros_like(opacities))
    idx = knn_indices(pts, means.detach(), alive, k=knn,
                      chunk=min(1024, pts.shape[0]))
    sdf = sdf_from_density(density_at(pts, idx, means, icovs, op))
    ideal, valid = ideal_sdf_from_depth(pts, depth.detach(), camera)
    err = torch.abs(sdf - torch.abs(ideal))
    return (torch.sum(torch.where(valid, err, torch.zeros_like(err)))
            / torch.clamp_min(torch.sum(valid), 1))
