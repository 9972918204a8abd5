"""Quaternion / rotation / covariance math, batched over leading dims.

Counterpart of fusionsense_tpu/core/transforms.py. Quaternion convention:
(w, x, y, z), unnormalized inputs accepted.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from fusionsense_tpu_torch.device import device_vector, resolve_device


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis."""
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = normalize(quat)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Branch-free: all four standard cases are computed and selected per
    matrix, trace first, then m00 >= m11, m22, then m11 >= m22."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def twice_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) * 2

    s0 = twice_sqrt(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = twice_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = twice_sqrt(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = twice_sqrt(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return normalize(q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions, broadcasting over leading dims."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit wxyz quaternion (its conjugate)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def random_quats(n: int, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """(n, 4) uniformly random unit quaternions (Shoemake method).

    Draws from a torch.Generator, so the numbers differ from the JAX
    package's jax.random stream for the same seed."""
    # drawn on the CPU generator, then moved: the stream is device-independent
    u, v, w = torch.rand((3, n), generator=generator).to(
        resolve_device(device)).unbind(0)
    two_pi = 2 * math.pi
    return torch.stack([
        torch.sqrt(1 - u) * torch.sin(two_pi * v),
        torch.sqrt(1 - u) * torch.cos(two_pi * v),
        torch.sqrt(u) * torch.sin(two_pi * w),
        torch.sqrt(u) * torch.cos(two_pi * w),
    ], dim=-1)


def rotation_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating unit vector(s) a onto b (batched Rodrigues);
    the antiparallel case rotates 180 degrees about an orthogonal axis."""
    a = normalize(a)
    b = normalize(b)
    c = torch.linalg.cross(a, b, dim=-1)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    q = torch.cat([1.0 + d, c], dim=-1)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    ortho = torch.where(torch.abs(a[..., :1]) < 0.9,
                        torch.linalg.cross(a, ex.expand_as(a), dim=-1),
                        torch.linalg.cross(a, ey.expand_as(a), dim=-1))
    q_anti = torch.cat([torch.zeros_like(d), normalize(ortho)], dim=-1)
    q = torch.where(d < -1.0 + 1e-6, q_anti, q)
    return normalize(q)


def exp_so3(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues, small-angle
    safe: neither branch of each select can produce a NaN gradient)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    tsq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(tsq_safe)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / tsq_safe)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def apply_se3_delta(viewmat: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-compose a small SE3 correction onto a (..., 4, 4) world-to-camera.

    delta = (..., 6): [rotation axis-angle (3), translation (3)]."""
    R = exp_so3(delta[..., :3])
    t = delta[..., 3:]
    Rv = viewmat[..., :3, :3]
    tv = viewmat[..., :3, 3]
    top = torch.cat(
        [R @ Rv, (torch.einsum("...ij,...j->...i", R, tv) + t)[..., None]], -1)
    bottom = device_vector((0.0, 0.0, 0.0, 1.0), viewmat.device,
                           viewmat.dtype).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def quat_scale_to_cov3d(quat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., 4), (..., 3) std-devs -> (..., 3, 3) covariance R S S^T R^T."""
    R = quat_to_rotmat(quat)
    M = R * scale[..., None, :]
    return M @ M.transpose(-1, -2)


def quat_scale_to_inv_cov3d(quat: torch.Tensor, scale: torch.Tensor,
                            eps: float = 1e-8) -> torch.Tensor:
    """Inverse covariance without a matrix solve: R S^-2 R^T."""
    R = quat_to_rotmat(quat)
    inv_s2 = 1.0 / torch.clamp_min(scale * scale, eps)
    return (R * inv_s2[..., None, :]) @ R.transpose(-1, -2)
