"""Gaussian projection: 3D means/covariances -> 2D screen conics (EWA), and
the quadratic log-alpha coefficients of the dense `jax` backend.

Counterpart of fusionsense_tpu/render/project.py: the same scalar-expanded
arithmetic, batched over the Gaussians, differentiable through autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fusionsense_tpu_torch.core.cameras import Camera


class Projected(NamedTuple):
    mean2d: torch.Tensor        # (N, 2) pixel coords
    depth: torch.Tensor         # (N,) camera z-depth
    conic: torch.Tensor         # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor        # (N,) screen-space extent in pixels (0 = culled)
    valid: torch.Tensor         # (N,) bool, survives frustum/size culling
    compensation: torch.Tensor  # (N,) antialiasing opacity compensation


def project_gaussians(means: torch.Tensor, quats: torch.Tensor,
                      scales: torch.Tensor, opacities: torch.Tensor,
                      camera: Camera, near: float = 0.01, far: float = 1e10,
                      eps2d: float = 0.3, antialiased: bool = False,
                      radius_clip: float = 0.0) -> Projected:
    viewmat = camera.viewmat.to(torch.float32)
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]

    p_cam = means @ R.T + t
    tz = p_cam[:, 2]
    in_depth = (tz > near) & (tz < far)
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)

    qn = quats / (torch.linalg.norm(quats, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    g00 = 1 - 2 * (y * y + z * z)
    g01 = 2 * (x * y - w * z)
    g02 = 2 * (x * z + w * y)
    g10 = 2 * (x * y + w * z)
    g11 = 1 - 2 * (x * x + z * z)
    g12 = 2 * (y * z - w * x)
    g20 = 2 * (x * z - w * y)
    g21 = 2 * (y * z + w * x)
    g22 = 1 - 2 * (x * x + y * y)
    m = [[R[i, 0] * g0 + R[i, 1] * g1 + R[i, 2] * g2
          for (g0, g1, g2) in ((g00, g10, g20), (g01, g11, g21),
                               (g02, g12, g22))] for i in range(3)]
    s2 = scales * scales
    s0, s1, s2_ = s2[:, 0], s2[:, 1], s2[:, 2]

    def cov(i, j):
        return (m[i][0] * s0 * m[j][0] + m[i][1] * s1 * m[j][1]
                + m[i][2] * s2_ * m[j][2])

    c00, c01, c02 = cov(0, 0), cov(0, 1), cov(0, 2)
    c11, c12, c22 = cov(1, 1), cov(1, 2), cov(2, 2)

    fx, fy = camera.fx, camera.fy
    W, H = camera.width, camera.height
    lim_x = 1.3 * (0.5 * W / fx)
    lim_y = 1.3 * (0.5 * H / fy)
    txz = torch.clamp(p_cam[:, 0] / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(p_cam[:, 1] / tz_safe, -lim_y, lim_y)
    inv_z = 1.0 / tz_safe
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z

    v00 = (j00 * j00 * c00 + 2 * j00 * j02 * c02 + j02 * j02 * c22)
    v11 = (j11 * j11 * c11 + 2 * j11 * j12 * c12 + j12 * j12 * c22)
    v01 = (j00 * j11 * c01 + j00 * j12 * c02
           + j02 * j11 * c12 + j02 * j12 * c22)

    det_orig = v00 * v11 - v01 * v01
    v00 = v00 + eps2d
    v11 = v11 + eps2d
    det = v00 * v11 - v01 * v01
    det_safe = torch.clamp_min(det, 1e-10)

    compensation = torch.sqrt(torch.clamp_min(det_orig / det_safe, 0.0))

    inv_det = 1.0 / det_safe
    conic = torch.stack([v11 * inv_det, -v01 * inv_det, v00 * inv_det], -1)

    mx = fx * p_cam[:, 0] * inv_z + camera.cx
    my = fy * p_cam[:, 1] * inv_z + camera.cy
    mean2d = torch.stack([mx, my], -1)

    mid = 0.5 * (v00 + v11)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

    valid = in_depth & (det > 0) & (radius > radius_clip)
    valid = valid & ((mx + radius > 0) & (mx - radius < W)
                     & (my + radius > 0) & (my - radius < H))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(mean2d=mean2d, depth=tz, conic=conic, radius=radius,
                     valid=valid, compensation=compensation)


def alpha_coefficients(mean2d: torch.Tensor, conic: torch.Tensor,
                       opacities: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """(N, 6) coefficients k with log alpha(p) = [x^2, xy, y^2, x, y, 1] . k,
    the `jax` backend's per-Gaussian input. Culled rows get a constant term
    of -1e10, so alpha underflows to exactly 0 and the backward stays
    finite."""
    mx, my = mean2d[:, 0], mean2d[:, 1]
    ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    log_op = torch.log(torch.clamp_min(opacities, 1e-12))
    k1 = -(0.5 * ca * mx * mx + cb * mx * my + 0.5 * cc * my * my) + log_op
    k1 = torch.where(valid, k1, torch.full_like(k1, -1e10))
    return torch.stack([-0.5 * ca, -cb, -0.5 * cc, ca * mx + cb * my,
                        cb * mx + cc * my, k1], -1)
