"""Minimal COLMAP text-model reader (cameras.txt / images.txt / points3D.txt).

Counterpart of fusionsense_tpu/data/colmap.py, kept as the port's own copy
(numpy only): the COLMAP-based layouts (CoolerMap / ScanNet++ style
exports) read their poses, intrinsics and sparse points through it. Text
format only; no pycolmap dependency.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray   # model-specific

    def intrinsics(self):
        """Returns (fx, fy, cx, cy); supported: SIMPLE_PINHOLE, PINHOLE,
        SIMPLE_RADIAL, OPENCV (distortion ignored with a warning upstream)."""
        p = self.params
        if self.model == "SIMPLE_PINHOLE":
            return p[0], p[0], p[1], p[2]
        if self.model == "PINHOLE":
            return p[0], p[1], p[2], p[3]
        if self.model in ("SIMPLE_RADIAL", "RADIAL"):
            return p[0], p[0], p[1], p[2]
        if self.model in ("OPENCV", "FULL_OPENCV"):
            return p[0], p[1], p[2], p[3]
        raise ValueError(f"unsupported COLMAP camera model {self.model}")


def _qvec_to_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_cameras_txt(path) -> dict[int, ColmapCamera]:
    cams = {}
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            model=parts[1], width=int(parts[2]), height=int(parts[3]),
            params=np.array([float(v) for v in parts[4:]]))
    return cams


def read_images_txt(path):
    """Returns list of dicts {name, camera_id, w2c (4x4 OpenCV)} sorted by
    name. images.txt has two lines per image; the 2nd (points) is skipped."""
    out = []
    expecting_image = True
    for ln in open(path):
        if ln.startswith("#"):
            continue
        if expecting_image:
            parts = ln.split()
            if len(parts) < 10:
                continue  # stray blank before any image line
            q = [float(v) for v in parts[1:5]]
            t = np.array([float(v) for v in parts[5:8]])
            w2c = np.eye(4)
            w2c[:3, :3] = _qvec_to_rot(q)
            w2c[:3, 3] = t
            out.append({"name": parts[9], "camera_id": int(parts[8]),
                        "w2c": w2c})
            expecting_image = False
        else:
            # the POINTS2D line (may be empty)
            expecting_image = True
    out.sort(key=lambda d: d["name"])
    return out


def read_points3d_txt(path, max_points: int | None = None):
    """(N, 3) xyz + (N, 3) rgb in [0, 1] from points3D.txt."""
    pts, cols = [], []
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        pts.append([float(v) for v in parts[1:4]])
        cols.append([float(v) / 255.0 for v in parts[4:7]])
        if max_points and len(pts) >= max_points:
            break
    return np.asarray(pts, np.float32), np.asarray(cols, np.float32)
