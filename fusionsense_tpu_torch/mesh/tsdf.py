"""TSDF fusion on a dense voxel grid, on the device.

Counterpart of fusionsense_tpu/mesh/tsdf.py: the projective TSDF update of
every voxel from one rendered depth map at a time (the reference's
vdbfusion integration: voxel 0.004, trunc 0.012, min_weight 5), on a
dense grid instead of a VDB tree, and the marching-tetrahedra surface of
the fused volume. The two float32 grids live on the device of the depth
maps; each view is a handful of elementwise passes over the voxels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.mesh.marching import marching_tetrahedra


@dataclasses.dataclass(frozen=True)
class TSDFConfig:
    voxel_size: float = 0.004
    truncation: float = 0.012
    min_weight: float = 5.0
    resolution: tuple = (256, 256, 256)
    origin: tuple = (-0.5, -0.5, -0.5)
    chunk: int = 2 ** 18


def voxel_centers(cfg: TSDFConfig, device=None) -> torch.Tensor:
    """(X*Y*Z, 3) float32 voxel center coordinates."""
    axes = []
    for n, o in zip(cfg.resolution, cfg.origin):
        a = torch.arange(n, dtype=torch.float32, device=device)
        axes.append(a * cfg.voxel_size + float(o) + cfg.voxel_size / 2)
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


def _check_size(cfg: TSDFConfig) -> None:
    """Guard to object-scale volumes: the dense sweep is O(X*Y*Z) per view
    and the two float32 grids live on the device. Room-scale scenes at a
    fixed voxel go to mesh/tsdf_sparse.py."""
    n = int(np.prod(cfg.resolution))
    if n > (1 << 27):
        raise ValueError(
            f"dense TSDF at {cfg.resolution} needs {n * 8 / 1e9:.1f} GB of "
            "grids; use fusionsense_tpu_torch.mesh.tsdf_sparse.SparseTSDF "
            "for room-scale scenes")


def integrate_view(tsdf: torch.Tensor, weight: torch.Tensor,
                   depth: torch.Tensor, viewmat: torch.Tensor, fx, fy, cx, cy,
                   *, width: int, height: int, cfg: TSDFConfig, vox=None):
    """Fuse one z-depth map (H, W) (0 = invalid) into the running (N,) tsdf
    and weight; returns the new pair. `vox` may hold voxel_centers(cfg) on
    the device, computed once for all views."""
    _check_size(cfg)
    if vox is None:
        vox = voxel_centers(cfg, depth.device)
    p_cam = vox @ viewmat[:3, :3].T + viewmat[:3, 3]
    z = p_cam[:, 2]
    zc = torch.clamp_min(z, 1e-6)
    u = p_cam[:, 0] / zc * fx + cx
    v = p_cam[:, 1] / zc * fy + cy
    # .to(int32) truncates toward zero, as the reference's astype
    ui = torch.clamp(u.to(torch.int32), 0, width - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, height - 1).long()
    in_img = (z > 1e-4) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    d = depth[vi, ui]
    valid = in_img & (d > 1e-4)
    sdf = d - z                              # + in front of surface
    upd = valid & (sdf > -cfg.truncation)
    tsdf_obs = torch.clamp(sdf / cfg.truncation, -1.0, 1.0)
    w_obs = upd.to(torch.float32)
    new_w = weight + w_obs
    new_ts = (tsdf * weight + tsdf_obs * w_obs) / torch.clamp_min(new_w, 1e-8)
    return new_ts, new_w


def fuse_depths(depths: torch.Tensor, cameras: Camera, cfg: TSDFConfig):
    """Integrate all views of depths (V, H, W). Returns (tsdf, weight)
    grids shaped cfg.resolution, on the depths' device."""
    _check_size(cfg)
    dev = depths.device
    n = int(np.prod(cfg.resolution))
    tsdf = torch.zeros((n,), device=dev)
    weight = torch.zeros((n,), device=dev)
    vox = voxel_centers(cfg, dev)
    for i in range(depths.shape[0]):
        tsdf, weight = integrate_view(
            tsdf, weight, depths[i], cameras.viewmat[i], cameras.fx[i],
            cameras.fy[i], cameras.cx[i], cameras.cy[i],
            width=cameras.width, height=cameras.height, cfg=cfg, vox=vox)
    return tsdf.reshape(cfg.resolution), weight.reshape(cfg.resolution)


def extract_mesh(tsdf: torch.Tensor, weight: torch.Tensor, cfg: TSDFConfig):
    """Marching-tetrahedra surface of the fused volume, on its device.
    Returns numpy (verts (V, 3) float32, faces (F, 3) int64)."""
    # unobserved / low-confidence voxels -> far outside (positive)
    field = torch.where(weight >= cfg.min_weight, tsdf,
                        torch.ones_like(tsdf))
    # the marching convention: inside = value < iso; tsdf is negative inside
    return marching_tetrahedra(
        field, iso=0.0, origin=np.asarray(cfg.origin) + cfg.voxel_size / 2,
        spacing=cfg.voxel_size)
