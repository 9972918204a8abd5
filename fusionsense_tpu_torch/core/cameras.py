"""Pinhole cameras: intrinsics + OpenCV world-to-camera extrinsics.

Counterpart of fusionsense_tpu/core/cameras.py. A batch of cameras is one
Camera whose tensors carry a leading view axis; width/height are ints.
"""
from __future__ import annotations

import dataclasses

import torch

from fusionsense_tpu_torch.device import resolve_device


def pick(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] for an int i, or for a (1,) int64 index tensor on x's device,
    read there: a CUDA graph of the step can take the view as an input."""
    return x[i] if isinstance(i, int) else x.index_select(0, i)[0]


@dataclasses.dataclass
class Camera:
    viewmat: torch.Tensor   # (..., 4, 4) world-to-camera (OpenCV)
    fx: torch.Tensor        # (...,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.viewmat.device

    @property
    def camtoworld(self) -> torch.Tensor:
        # inv_ex: the numbers of inv, without its error check's host sync
        return torch.linalg.inv_ex(self.viewmat).inverse

    @property
    def origin(self) -> torch.Tensor:
        """(..., 3) camera center in world coordinates."""
        R = self.viewmat[..., :3, :3]
        t = self.viewmat[..., :3, 3]
        return -torch.einsum("...ji,...j->...i", R, t)

    def index(self, i) -> "Camera":
        """Camera i of a batched Camera (i as `pick` takes it)."""
        return Camera(viewmat=pick(self.viewmat, i), fx=pick(self.fx, i),
                      fy=pick(self.fy, i), cx=pick(self.cx, i),
                      cy=pick(self.cy, i), width=self.width,
                      height=self.height)

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


def make_camera(viewmat, fx, fy, cx, cy, width, height, device=None) -> Camera:
    dev = resolve_device(device)
    asf = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    return Camera(viewmat=asf(viewmat), fx=asf(fx), fy=asf(fy), cx=asf(cx),
                  cy=asf(cy), width=int(width), height=int(height))


def backproject_depth(depth: torch.Tensor, camera: Camera) -> torch.Tensor:
    """(H, W) z-depth map -> (H*W, 3) world points."""
    H, W = depth.shape
    ys = torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    z = depth.reshape(-1)
    x = (gx.reshape(-1) - camera.cx) / camera.fx * z
    y = (gy.reshape(-1) - camera.cy) / camera.fy * z
    pts_cam = torch.stack([x, y, z], dim=-1)
    c2w = camera.camtoworld
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def pixel_centers(width: int, height: int, device=None) -> torch.Tensor:
    """(H, W, 2) pixel-center coordinates (x, y)."""
    dev = resolve_device(device)
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)
