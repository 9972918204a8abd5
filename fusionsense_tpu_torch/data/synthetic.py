"""Procedural test scenes: ring cameras around a textured sphere, and
GelSight-style touch patches on it.

Counterpart of the sphere helpers of fusionsense_tpu/data/synthetic.py. The
geometry is computed with numpy in float64 and cast to float32, exactly as
the JAX package does, so both packages build the same scene.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera, make_camera
from fusionsense_tpu_torch.device import resolve_device


def look_at_w2c(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1)) -> np.ndarray:
    """OpenCV world-to-camera matrix looking from eye at target."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def ring_cameras(n_views: int = 9, radius: float = 2.0, height: float = 0.8,
                 width: int = 128, height_px: int = 96, focal: float = 110.0,
                 target=(0.0, 0.0, 0.0), device=None) -> Camera:
    """Batched Camera: n_views on a ring looking at the target."""
    tgt = np.asarray(target, np.float64)
    mats = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        eye = np.array([radius * math.cos(a), radius * math.sin(a), height])
        mats.append(look_at_w2c(eye, tgt))
    ones = np.ones((n_views,), np.float32)
    return make_camera(np.stack(mats).astype(np.float32), focal * ones,
                       focal * ones, (width / 2) * ones, (height_px / 2) * ones,
                       width, height_px, device=device)


def sphere_points(n: int = 2000, radius: float = 0.5, seed: int = 0,
                  device=None):
    """Fibonacci-sphere points, a procedural color texture and normals.
    (`seed` is accepted for signature parity; the points are deterministic.)"""
    dev = resolve_device(device)
    i = np.arange(n, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1 - y * y, 0))
    theta = phi * i
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), y], axis=-1)
    colors = 0.5 + 0.45 * np.stack(
        [np.sin(4 * pts[:, 0] + 1), np.sin(5 * pts[:, 1]),
         np.sin(6 * pts[:, 2] + 2)], axis=-1)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    return f32(pts * radius), f32(np.clip(colors, 0, 1)), f32(pts.copy())


def sphere_depth_normals(camera: Camera, center=(0.0, 0.0, 0.0),
                         radius: float = 0.5):
    """Analytic ray-traced z-depth + world normals of the GT sphere for ONE
    camera. Returns (depth (H, W), normal (H, W, 3), mask (H, W))."""
    H, W = camera.height, camera.width
    dev = camera.device
    c2w = camera.camtoworld
    origin = camera.origin
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs_cam = torch.stack([(gx - camera.cx) / camera.fx,
                            (gy - camera.cy) / camera.fy,
                            torch.ones_like(gx)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dn = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    ctr = torch.tensor(center, dtype=torch.float32, device=dev)
    oc = origin - ctr
    b = torch.sum(dn * oc, -1)
    c = torch.sum(oc * oc) - radius ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    pts = origin + t[..., None] * dn
    normal = (pts - ctr) / radius
    z = (pts @ camera.viewmat[:3, :3].T + camera.viewmat[:3, 3])[..., 2]
    depth = torch.where(hit, z, torch.zeros_like(z))
    normal = torch.where(hit[..., None], normal, torch.zeros_like(normal))
    return depth, normal, hit.to(torch.float32)


def sphere_touch_patches(n_patches=4, pts_per_patch=400, radius=0.5,
                         cap_deg=8.0, seed=7):
    """Synthetic GelSight-style patches on the analytic sphere: small
    spherical caps with exact surface normals and PCA oriented bboxes
    (numpy TouchPatch objects, the same numbers as the JAX package's)."""
    from fusionsense_tpu_torch.data.tactile import TouchPatch, oriented_bbox

    rng = np.random.RandomState(seed)
    patches = []
    for k in range(n_patches):
        theta = 2 * np.pi * (k / n_patches + 0.1)
        phi = np.pi / 2 + rng.uniform(-0.6, 0.6)
        c = np.array([np.sin(phi) * np.cos(theta),
                      np.sin(phi) * np.sin(theta), np.cos(phi)])
        up = np.array([0.0, 0.0, 1.0])
        t1 = np.cross(up, c)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(c, t1)
        ang = np.deg2rad(cap_deg)
        a = np.sqrt(rng.rand(pts_per_patch)) * ang
        b = rng.rand(pts_per_patch) * 2 * np.pi
        dirs = (np.cos(a)[:, None] * c[None]
                + np.sin(a)[:, None] * (np.cos(b)[:, None] * t1[None]
                                        + np.sin(b)[:, None] * t2[None]))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pts = (radius * dirs).astype(np.float32)
        center, R, ext = oriented_bbox(pts, pad=2e-3)
        patches.append(TouchPatch(
            points=pts, colors=np.full_like(pts, 0.6),
            normals=dirs.astype(np.float32), bbox_center=center,
            bbox_rot=R, bbox_extent=ext))
    return patches
