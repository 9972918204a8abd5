"""Spherical-harmonics color evaluation (degrees 0-3).

Counterpart of fusionsense_tpu/core/sh.py. Coefficient layout (..., K, 3)
with K = (deg+1)^2, channel-last.
"""
from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(coeffs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., K, 3) coefficients at (..., 3) unit directions -> (..., 3) raw
    color (the caller adds +0.5 and clamps)."""
    result = _C0 * coeffs[..., 0, :]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (result
                  - _C1 * y * coeffs[..., 1, :]
                  + _C1 * z * coeffs[..., 2, :]
                  - _C1 * x * coeffs[..., 3, :])
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + _C2[0] * xy * coeffs[..., 4, :]
                  + _C2[1] * yz * coeffs[..., 5, :]
                  + _C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
                  + _C2[3] * xz * coeffs[..., 7, :]
                  + _C2[4] * (xx - yy) * coeffs[..., 8, :])
    if degree >= 3:
        result = (result
                  + _C3[0] * y * (3 * xx - yy) * coeffs[..., 9, :]
                  + _C3[1] * xy * z * coeffs[..., 10, :]
                  + _C3[2] * y * (4 * zz - xx - yy) * coeffs[..., 11, :]
                  + _C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * coeffs[..., 12, :]
                  + _C3[4] * x * (4 * zz - xx - yy) * coeffs[..., 13, :]
                  + _C3[5] * z * (xx - yy) * coeffs[..., 14, :]
                  + _C3[6] * x * (xx - 3 * yy) * coeffs[..., 15, :])
    return result


def rgb_to_sh0(rgb: torch.Tensor) -> torch.Tensor:
    """Color c -> dc coefficient with eval(dc) = c - 0.5."""
    return (rgb - 0.5) / _C0


def sh0_to_rgb(dc: torch.Tensor) -> torch.Tensor:
    return dc * _C0 + 0.5
