"""Tactile (GelSight) patch loading: pcd -> metric 3D patches with normals
and oriented bounding boxes.

Counterpart of fusionsense_tpu/data/tactile.py (numpy, as there):
- `gelsight_transform.json` lists per-touch frames {file_path (pcd),
  transform_matrix (patch pose in world)},
- patch points are downsampled x5 and scaled by gel_scale = 6.34e-5 m per
  sensor unit,
- an optional mask (.pcd/.npy) selects the contact region,
- sensor normals are 2D (surface gradient) and lifted to 3D with
  z = -sqrt(1 - x^2 - y^2),
- an oriented bounding box around the patch defines the cull region for
  anchored-Gaussian insertion.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from fusionsense_tpu_torch.utils.ply import read_pcd, read_ply

GEL_SCALE_DEFAULT = 6.34e-5
DOWNSAMPLE_DEFAULT = 5


@dataclasses.dataclass
class TouchPatch:
    points: np.ndarray    # (P, 3) world (scene-normalized) coords
    colors: np.ndarray    # (P, 3)
    normals: np.ndarray   # (P, 3) world-frame unit normals
    bbox_center: np.ndarray   # (3,)
    bbox_rot: np.ndarray      # (3, 3) rows = box axes
    bbox_extent: np.ndarray   # (3,) half-extents


def lift_normals_2d(n2d: np.ndarray) -> np.ndarray:
    """(P, 2) gel-surface gradient normals -> (P, 3) with z=-sqrt(1-x^2-y^2)."""
    xy2 = np.clip(np.sum(n2d ** 2, axis=-1), 0.0, 1.0)
    z = -np.sqrt(1.0 - xy2)
    n = np.concatenate([n2d, z[:, None]], axis=-1)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)


def oriented_bbox(points: np.ndarray, pad: float = 1e-4):
    """PCA oriented bounding box: (center, R (rows=axes), half-extents)."""
    center = points.mean(axis=0)
    x = points - center
    cov = x.T @ x / max(len(points), 1)
    _, vecs = np.linalg.eigh(cov)
    R = vecs.T[::-1]  # rows: principal axes, largest variance first
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    local = x @ R.T
    ext = np.abs(local).max(axis=0) + pad
    return center, R, ext


def points_in_obb(points, center, R, extent):
    """Boolean mask of points inside an oriented box. Works with numpy
    arrays, or with torch tensors when every argument is one."""
    local = (points - center) @ R.T
    absl = abs(local)
    return ((absl[..., 0] <= extent[0]) & (absl[..., 1] <= extent[1])
            & (absl[..., 2] <= extent[2]))


def _read_points_any(path: Path) -> dict:
    if path.suffix == ".pcd":
        return read_pcd(path)
    return read_ply(path)


def load_touch_patches(
    gelsight_json: Path,
    translate=np.zeros(3),
    scale: float = 1.0,
    gel_scale: float | None = None,
    downsample: int = DOWNSAMPLE_DEFAULT,
) -> list[TouchPatch]:
    gelsight_json = Path(gelsight_json)
    base = gelsight_json.parent
    with open(gelsight_json) as f:
        meta = json.load(f)
    gel = gel_scale if gel_scale is not None else meta.get(
        "gel_scale", GEL_SCALE_DEFAULT)

    patches = []
    for fr in meta["frames"]:
        p = base / Path(fr["file_path"]).name if not Path(
            fr["file_path"]).is_absolute() else Path(fr["file_path"])
        if not p.exists():
            p = base.parent / fr["file_path"]
        d = _read_points_any(p)
        pts = d["points"][::downsample].astype(np.float64) * gel
        colors = d.get("colors")
        colors = (colors[::downsample] if colors is not None
                  else np.full((len(pts), 3), 0.5, np.float32))

        # optional contact mask
        mask_path = fr.get("mask_path")
        if mask_path:
            mp = base / mask_path
            if mp.suffix == ".npy":
                m = np.load(mp).reshape(-1)[::downsample].astype(bool)
            else:
                m = _read_points_any(mp).get("mask", np.ones(len(pts)))
                m = np.asarray(m).reshape(-1)[::downsample].astype(bool)
            m = m[: len(pts)]
            pts, colors = pts[m], colors[m]
        if len(pts) == 0:
            continue

        # sensor normals: 2D fields lifted, else flat -z sensor normal
        if "normal_x" in d and "normal_y" in d:
            n2d = np.stack([np.asarray(d["normal_x"], np.float64),
                            np.asarray(d["normal_y"], np.float64)], -1)
            n2d = n2d[::downsample][: len(pts)]
            normals = lift_normals_2d(n2d)
        elif "normals" in d:
            normals = np.asarray(d["normals"], np.float64)[::downsample][: len(pts)]
        else:
            normals = np.tile([0.0, 0.0, -1.0], (len(pts), 1))

        # patch pose -> world, then scene normalization
        T = np.asarray(fr["transform_matrix"], np.float64)
        pts_w = pts @ T[:3, :3].T + T[:3, 3]
        pts_w = (pts_w + translate) * scale
        normals_w = normals @ T[:3, :3].T
        normals_w /= np.maximum(
            np.linalg.norm(normals_w, axis=-1, keepdims=True), 1e-8)

        center, R, ext = oriented_bbox(pts_w)
        patches.append(TouchPatch(
            points=pts_w.astype(np.float32), colors=colors.astype(np.float32),
            normals=normals_w.astype(np.float32),
            bbox_center=center.astype(np.float32), bbox_rot=R.astype(np.float32),
            bbox_extent=ext.astype(np.float32),
        ))
    return patches
