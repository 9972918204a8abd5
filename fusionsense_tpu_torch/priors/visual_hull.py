"""Visual hull by voxel space carving, on the masks' device.

Counterpart of fusionsense_tpu/priors/visual_hull.py:
- a cube of `extent` (1 m) split into `voxel_size` (5 mm) voxels, centred
  on the scene,
- every voxel is projected into every view's binary object mask and counts
  the views whose mask holds it (pixel index by int32 truncation, clipped to
  the image, as the JAX vote does),
- the hull keeps the voxels with votes >= max_votes - ceil(error% * V).
The vote runs one chunk of voxels at a time, every view inside the chunk,
so its memory stays near the chunk (the 200^3 grid is 8 M voxels). The
voxel centres are np.linspace's float64 values cast to float32, as the JAX
package builds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera


@dataclasses.dataclass(frozen=True)
class VisualHullConfig:
    voxel_size: float = 0.005
    extent: float = 1.0               # cube side length
    error_percent: float = 5.0        # vote tolerance


_CHUNK = 1 << 20     # voxels voted at a time


def _vote(vox: torch.Tensor, masks: torch.Tensor, cameras: Camera):
    """(n, 3) voxel centres -> (n,) int32 count of the views whose mask
    holds each voxel's projection."""
    H, W = cameras.height, cameras.width
    votes = torch.zeros(vox.shape[0], dtype=torch.int32, device=vox.device)
    for i in range(masks.shape[0]):
        vm = cameras.viewmat[i]
        p = vox @ vm[:3, :3].T + vm[:3, 3]
        z = torch.clamp_min(p[:, 2], 1e-6)
        u = p[:, 0] / z * cameras.fx[i] + cameras.cx[i]
        v = p[:, 1] / z * cameras.fy[i] + cameras.cy[i]
        ui = torch.clamp(u.to(torch.int32), 0, W - 1).long()
        vi = torch.clamp(v.to(torch.int32), 0, H - 1).long()
        inside = ((p[:, 2] > 1e-6) & (u >= 0) & (u < W) & (v >= 0) & (v < H))
        votes += (inside & (masks[i][vi, ui] > 0.5)).to(torch.int32)
    return votes


def visual_hull(masks: torch.Tensor, cameras: Camera,
                center: np.ndarray | None = None,
                cfg: VisualHullConfig = VisualHullConfig()) -> np.ndarray:
    """Carve the hull from (V, H, W) masks and their batched cameras (both on
    one device). Returns the (M, 3) hull points as host float32."""
    V = masks.shape[0]
    dev = masks.device
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    half = cfg.extent / 2
    n_side = int(round(cfg.extent / cfg.voxel_size))
    xs = np.linspace(-half + cfg.voxel_size / 2, half - cfg.voxel_size / 2,
                     n_side)
    axes = torch.as_tensor(np.stack([xs + c for c in center]).astype(
        np.float32), device=dev)                       # (3, n_side)
    n = n_side ** 3
    votes = torch.empty(n, dtype=torch.int32, device=dev)
    for start in range(0, n, _CHUNK):
        idx = torch.arange(start, min(start + _CHUNK, n), device=dev)
        ijk = (idx // (n_side * n_side), idx // n_side % n_side, idx % n_side)
        vox = torch.stack([axes[a][ijk[a]] for a in range(3)], -1)
        votes[start:start + idx.shape[0]] = _vote(vox, masks, cameras)
    max_votes = int(votes.max()) if n else 0
    thresh = max_votes - int(np.ceil(cfg.error_percent / 100.0 * V))
    keep = torch.nonzero(votes >= max(thresh, 1))[:, 0]
    ijk = (keep // (n_side * n_side), keep // n_side % n_side, keep % n_side)
    return torch.stack([axes[a][ijk[a]] for a in range(3)], -1).cpu().numpy()
