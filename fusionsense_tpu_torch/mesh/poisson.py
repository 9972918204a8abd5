"""Poisson surface reconstruction on a regular grid via FFT, on the device.

Counterpart of fusionsense_tpu/mesh/poisson.py. The reference uses open3d's
screened Poisson (Kazhdan) for its `gaussians`, `dn` and `sugar-coarse`
meshes; here, as in the JAX package, the classic FFT formulation (Kazhdan
2005): on a regular grid laplacian(chi) = div V, V the smoothed oriented
normal field, is diagonal in Fourier space, so the solve is a trilinear
scatter of the normals and a few 3-D FFTs (torch.fft in complex64, the
library counterpart of the XLA FFT the JAX package calls outside any
kernel). The scatter-add's order, and so its last bits, differ from
XLA's on the card. The trim of far vertices runs on the host with scipy.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fusionsense_tpu_torch.device import resolve_device
from fusionsense_tpu_torch.mesh.marching import marching_tetrahedra


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    resolution: int = 160
    padding: float = 0.15        # fraction of extent padded on each side
    smooth_sigma: float = 1.5    # Gaussian pre-smoothing of V (voxels)
    # drop mesh vertices farther than this many voxels from any input
    # sample (the FFT solve is periodic, so far-field chi noise can emit
    # spurious sheets; this mirrors open3d's low-density vertex removal
    # after screened Poisson). <= 0 disables.
    trim_voxels: float = 4.0


def _scatter_field(points: torch.Tensor, normals: torch.Tensor,
                   res: int) -> torch.Tensor:
    """Trilinear scatter of normals (P, 3) into a (res, res, res, 3)
    float32 field. Points must be pre-normalised to [0, res-1]^3."""
    base = torch.floor(points)
    frac = points - base
    b = base.to(torch.int32)
    field = torch.zeros((res, res, res, 3), device=points.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = (torch.abs(1 - dx - frac[:, 0])
                     * torch.abs(1 - dy - frac[:, 1])
                     * torch.abs(1 - dz - frac[:, 2]))
                off = torch.tensor([dx, dy, dz], dtype=torch.int32,
                                   device=points.device)
                idx = torch.clamp(b + off, 0, res - 1).long()
                field.index_put_((idx[:, 0], idx[:, 1], idx[:, 2]),
                                 w[:, None] * normals, accumulate=True)
    return field


def _solve(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """chi with laplacian(chi) = div(smooth(field)), periodic boundaries."""
    res = field.shape[0]
    k = torch.fft.fftfreq(res, device=field.device) * 2 * math.pi
    kx = k[:, None, None]
    ky = k[None, :, None]
    kz = k[None, None, :]
    k2 = kx ** 2 + ky ** 2 + kz ** 2

    Fx = torch.fft.fftn(field[..., 0])
    Fy = torch.fft.fftn(field[..., 1])
    Fz = torch.fft.fftn(field[..., 2])
    # Gaussian smoothing in the Fourier domain: a std-sigma-voxel Gaussian
    # has transfer function exp(-sigma^2 |omega|^2 / 2), omega in rad/voxel
    g = torch.exp(-0.5 * (sigma ** 2) * k2)
    div_hat = 1j * (kx * Fx + ky * Fy + kz * Fz) * g
    zero = k2 == 0
    k2_safe = torch.where(zero, torch.ones_like(k2), k2)
    chi_hat = torch.where(zero, torch.zeros_like(div_hat), -div_hat / k2_safe)
    return torch.fft.ifftn(chi_hat).real


def poisson_reconstruct(points, normals, cfg: PoissonConfig = PoissonConfig(),
                        device=None):
    """Oriented point cloud (numpy (P, 3) points and normals) -> numpy
    (verts, faces) watertight mesh; the grid work runs on `device` (the
    card by default)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    lo = points.min(0)
    hi = points.max(0)
    extent = float((hi - lo).max())
    pad = cfg.padding * extent
    origin = lo - pad
    scale = (extent + 2 * pad) / (cfg.resolution - 1)

    grid_pts = (points - origin) / scale
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    field = _scatter_field(f32(grid_pts), f32(normals), cfg.resolution)
    chi = _solve(field, cfg.smooth_sigma)

    # iso level = mean chi at the input samples (averaged on the host, as
    # the reference's numpy mean)
    gp = np.clip(np.round(grid_pts).astype(np.int64), 0, cfg.resolution - 1)
    gpt = torch.as_tensor(gp, device=dev)
    iso = float(np.mean(chi[gpt[:, 0], gpt[:, 1], gpt[:, 2]].cpu().numpy()))

    # orientation: chi is higher inside when normals point outward
    # (div of outward field is negative inside). The marching convention is
    # "inside = value < iso", so negate.
    verts, faces = marching_tetrahedra(-chi, iso=-iso, origin=origin,
                                       spacing=scale)

    if cfg.trim_voxels > 0 and len(verts) and len(points):
        from scipy.spatial import cKDTree

        d, _ = cKDTree(points).query(verts, k=1, workers=-1)
        keep = d <= cfg.trim_voxels * scale
        if keep.any() and not keep.all():
            remap = np.full(len(verts), -1, np.int64)
            remap[keep] = np.arange(int(keep.sum()))
            verts = verts[keep]
            fkeep = keep[faces].all(axis=1)
            faces = remap[faces[fkeep]]
    return verts, faces
