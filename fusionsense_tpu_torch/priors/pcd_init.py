"""Seed point cloud from depth maps and the visual hull.

Counterpart of fusionsense_tpu/priors/pcd_init.py:
- back-project each view's depth map (strided, with the intrinsics divided
  by the stride) through core/cameras.backproject_depth,
- background = depth in (fg_max, bg_max], voxel-downsampled (0.02) keeping
  the first point that lands in each voxel,
- merged with the visual-hull points painted black (the hull first).
Everything up to the merge runs on the depth maps' device.
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera, backproject_depth


def voxel_downsample(points: torch.Tensor, colors: torch.Tensor | None,
                     voxel: float):
    """Keep one point per occupied voxel: the first to land in it, in the
    points' order (np.unique's return_index, sorted)."""
    key = torch.floor(points / voxel).to(torch.int64)
    _, inv = torch.unique(key, dim=0, return_inverse=True)
    n = points.shape[0]
    first = torch.full((int(inv.max()) + 1 if n else 0,), n, dtype=torch.int64,
                       device=points.device)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=points.device),
                                 reduce="amin")
    first = torch.sort(first).values
    return points[first], (colors[first] if colors is not None else None)


def seed_pcd_from_depths(depths: torch.Tensor, images: torch.Tensor,
                         cameras: Camera,
                         hull_points: np.ndarray | None = None,
                         fg_max: float = 0.5, bg_max: float = 5.0,
                         bg_voxel: float = 0.02, stride: int = 2):
    """(V, H, W) depths, (V, H, W, 3) images -> the training seed cloud as
    host float32 (points (N, 3), colors (N, 3))."""
    bg_pts, bg_cols = [], []
    for i in range(depths.shape[0]):
        d = depths[i][::stride, ::stride]
        img = images[i][::stride, ::stride]
        cam_i = cameras.index(i)
        sub = Camera(viewmat=cam_i.viewmat, fx=cam_i.fx / stride,
                     fy=cam_i.fy / stride, cx=cam_i.cx / stride,
                     cy=cam_i.cy / stride, width=d.shape[1], height=d.shape[0])
        pts = backproject_depth(d, sub)
        dd = d.reshape(-1)
        bg = (dd > fg_max) & (dd <= bg_max)
        bg_pts.append(pts[bg])
        bg_cols.append(img.reshape(-1, 3)[bg])
    dev = depths.device
    bg_pts = torch.cat(bg_pts) if bg_pts else torch.zeros((0, 3), device=dev)
    bg_cols = torch.cat(bg_cols) if bg_cols else torch.zeros((0, 3), device=dev)
    if len(bg_pts):
        bg_pts, bg_cols = voxel_downsample(bg_pts, bg_cols, bg_voxel)
    bg_pts = bg_pts.cpu().numpy().astype(np.float32)
    bg_cols = bg_cols.cpu().numpy().astype(np.float32)
    if hull_points is not None and len(hull_points):
        hull_cols = np.zeros((len(hull_points), 3), np.float32)
        return (np.concatenate([np.asarray(hull_points, np.float32), bg_pts]),
                np.concatenate([hull_cols, bg_cols]))
    return bg_pts, bg_cols
