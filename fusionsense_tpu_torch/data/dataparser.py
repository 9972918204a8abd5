"""transforms.json dataparser: poses, intrinsics, splits, priors, seed pcds.

Counterpart of fusionsense_tpu/data/dataparser.py, with the same on-disk
contract (the nerfstudio-style `transforms.json` layout):
- frames natural-sorted by file path, OpenGL c2w -> OpenCV w2c, optional
  auto-center/scale of the camera origins,
- train/val/test splits from `train_filenames` etc.,
- the seed point cloud `ply_file_path` and the visual hull
  `object_pc_path`, loaded in scene coordinates,
- per-frame sensor depth (16-bit png, mm -> m, or .npy in meters), mono
  depth, normal maps (png [0,1] -> [-1,1], or .npy; camera- or
  world-frame), binary masks,
- tactile patches from `tactile/gelsight_transform.json`.

Images are read through data/image_io.py (Pillow), stacked on
the host and moved to the cameras' device once.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera, make_camera
from fusionsense_tpu_torch.data.image_io import load_image
from fusionsense_tpu_torch.utils.ply import read_ply


def natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


@dataclasses.dataclass(frozen=True)
class DataParserConfig:
    data_dir: str = "."
    auto_center: bool = True
    auto_scale: bool = True
    scale_factor: float = 1.0
    scene_scale: float = 5.0          # fixed AABB extent
    depth_unit_scale: float = 1.0 / 1000.0  # 16-bit png mm -> meters
    normal_format: str = "opengl_cam"  # "opengl_cam"|"opencv_cam"|"world"
    load_touches: bool = False
    downscale_factor: int = 1


@dataclasses.dataclass
class ParsedScene:
    cameras: Camera                    # batched over ALL frames (sorted)
    image_paths: list
    depth_paths: list
    mono_depth_paths: list
    normal_paths: list
    mask_paths: list
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray
    seed_points: Optional[np.ndarray] = None    # (N, 3)
    seed_colors: Optional[np.ndarray] = None
    seed_normals: Optional[np.ndarray] = None
    hull_points: Optional[np.ndarray] = None    # visual hull (object_pc_path)
    touch_patches: Optional[list] = None
    # pose normalization: applied world = (raw world + translate) * scale
    translate: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    # the layout's own 16-bit depth unit (Replica's 1/6553.5); None means
    # the caller's DataParserConfig.depth_unit_scale. The layout knows its
    # unit, not the caller, so it travels with the scene.
    depth_unit_scale: Optional[float] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def untransform_points(self, pts: np.ndarray) -> np.ndarray:
        """Scene coords -> original capture/world coords."""
        return pts / self.scale - self.translate


def _resolve(data_dir: Path, p: str) -> Path:
    q = Path(p)
    return q if q.is_absolute() else data_dir / q


def parse_transforms(cfg: DataParserConfig, device=None) -> ParsedScene:
    """Parse `<data_dir>/transforms.json`; the cameras go to `device` (the
    card by default)."""
    data_dir = Path(cfg.data_dir)
    with open(data_dir / "transforms.json") as f:
        meta = json.load(f)

    frames = sorted(meta["frames"], key=lambda fr: natsort_key(fr["file_path"]))

    def intr(fr, key, default=None):
        return fr.get(key, meta.get(key, default))

    c2w_gl = np.array([fr["transform_matrix"] for fr in frames], np.float64)
    c2w = c2w_gl @ np.diag([1.0, -1.0, -1.0, 1.0])   # OpenGL -> OpenCV

    origins = c2w[:, :3, 3]
    translate = -origins.mean(axis=0) if cfg.auto_center else np.zeros(3)
    origins_c = origins + translate
    scale = cfg.scale_factor
    if cfg.auto_scale:
        scale = cfg.scale_factor / max(float(np.abs(origins_c).max()), 1e-8)
    c2w[:, :3, 3] = origins_c * scale
    w2c = np.linalg.inv(c2w)

    d = cfg.downscale_factor
    fx = np.array([intr(fr, "fl_x") for fr in frames], np.float32) / d
    fy = np.array([intr(fr, "fl_y") for fr in frames], np.float32) / d
    cx = np.array([intr(fr, "cx") for fr in frames], np.float32) / d
    cy = np.array([intr(fr, "cy") for fr in frames], np.float32) / d
    width = int(intr(frames[0], "w")) // d
    height = int(intr(frames[0], "h")) // d

    cameras = make_camera(np.asarray(w2c, np.float32), fx, fy, cx, cy,
                          width, height, device=device)

    names = [Path(fr["file_path"]).name for fr in frames]

    def split_idx(key):
        wanted = meta.get(key)
        if not wanted:
            return np.array([], np.int32)
        wanted = {Path(w).name for w in wanted}
        return np.array([i for i, n in enumerate(names) if n in wanted], np.int32)

    train_idx = split_idx("train_filenames")
    val_idx = split_idx("val_filenames")
    test_idx = split_idx("test_filenames")
    if train_idx.size == 0:
        train_idx = np.arange(len(frames), dtype=np.int32)

    def paths(key):
        return [_resolve(data_dir, fr[key]) if key in fr else None
                for fr in frames]

    scene = ParsedScene(
        cameras=cameras,
        image_paths=[_resolve(data_dir, fr["file_path"]) for fr in frames],
        depth_paths=paths("depth_file_path"),
        mono_depth_paths=paths("mono_depth_file_path"),
        normal_paths=paths("normal_file_path"),
        mask_paths=paths("mask_file_path"),
        train_idx=train_idx, val_idx=val_idx, test_idx=test_idx,
        translate=translate, scale=scale, meta=meta,
    )

    def load_pcd_scaled(path):
        d_ = read_ply(path)
        pts = (d_["points"] + translate) * scale
        return pts, d_.get("colors"), d_.get("normals")

    if meta.get("ply_file_path"):
        p = _resolve(data_dir, meta["ply_file_path"])
        if p.exists():
            scene.seed_points, scene.seed_colors, scene.seed_normals = (
                load_pcd_scaled(p))
    if meta.get("object_pc_path"):
        p = _resolve(data_dir, meta["object_pc_path"])
        if p.exists():
            scene.hull_points = load_pcd_scaled(p)[0]

    if cfg.load_touches:
        from fusionsense_tpu_torch.data.tactile import load_touch_patches

        gt_path = data_dir / "tactile" / "gelsight_transform.json"
        if gt_path.exists():
            scene.touch_patches = load_touch_patches(
                gt_path, translate=translate, scale=scale)

    return scene


# ------------------------------------------------------------ images -------

def load_rgb(path, downscale=1) -> np.ndarray:
    arr = load_image(path, downscale).astype(np.float32)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr / 255.0


def load_depth(path, unit_scale=1e-3, downscale=1) -> np.ndarray:
    """16-bit png in mm (the capture convention) or .npy in meters."""
    path = Path(path)
    if path.suffix == ".npy":
        d = np.load(path).astype(np.float32)
        if downscale > 1:
            d = d[::downscale, ::downscale]
        return d
    arr = load_image(path, downscale)[..., 0].astype(np.float32)
    return arr * unit_scale


def load_normal(path, w2c=None, fmt="opengl_cam", downscale=1) -> np.ndarray:
    """Normal map -> world-space unit normals (H, W, 3): png stores
    (n + 1) / 2, npy stores raw [-1, 1]."""
    path = Path(path)
    if path.suffix == ".npy":
        n = np.load(path).astype(np.float32)
        if n.ndim == 3 and n.shape[0] == 3:
            n = n.transpose(1, 2, 0)
        if downscale > 1:
            n = n[::downscale, ::downscale]
    else:
        n = load_image(path, downscale)[..., :3].astype(np.float32) / 255.0
        n = n * 2.0 - 1.0
    if fmt == "opengl_cam":
        n = n * np.array([1.0, -1.0, -1.0], np.float32)  # -> opencv cam
        fmt = "opencv_cam"
    if fmt == "opencv_cam":
        if w2c is None:
            raise ValueError("camera-frame normals need the view's pose")
        R = np.asarray(w2c)[:3, :3]
        n = n @ R  # R^T @ n per pixel
    n_norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(n_norm, 1e-8)).astype(np.float32)


def load_mask(path, downscale=1) -> np.ndarray:
    arr = load_image(path, downscale)[..., 0]
    return (arr > 127).astype(np.float32)


def load_train_data(scene: ParsedScene, cfg: DataParserConfig,
                    split: str = "train"):
    """Stack a split's views into a (Camera, TrainData) pair on the scene's
    device."""
    from fusionsense_tpu_torch.train.trainer import TrainData

    idx = {"train": scene.train_idx, "val": scene.val_idx,
           "test": scene.test_idx}[split]
    idx = np.asarray(idx, np.int64)
    d = cfg.downscale_factor
    cam = scene.cameras
    dev = cam.device
    viewmats = cam.viewmat.cpu().numpy()

    images = np.stack([load_rgb(scene.image_paths[i], d) for i in idx])

    def maybe_stack(paths, loader):
        sel = [paths[i] for i in idx]
        if any(p is None for p in sel):
            return None
        return np.stack([loader(i) for i in idx])

    unit = (scene.depth_unit_scale if scene.depth_unit_scale is not None
            else cfg.depth_unit_scale)
    depths = maybe_stack(
        scene.depth_paths,
        lambda i: load_depth(scene.depth_paths[i], unit, d) * scene.scale)
    mono = maybe_stack(
        scene.mono_depth_paths,
        lambda i: load_depth(scene.mono_depth_paths[i], unit, d) * scene.scale)
    normals = maybe_stack(
        scene.normal_paths,
        lambda i: load_normal(scene.normal_paths[i], viewmats[i],
                              cfg.normal_format, d))
    masks = maybe_stack(scene.mask_paths,
                        lambda i: load_mask(scene.mask_paths[i], d))

    ti = torch.as_tensor(idx, device=dev)
    sub = Camera(viewmat=cam.viewmat[ti], fx=cam.fx[ti], fy=cam.fy[ti],
                 cx=cam.cx[ti], cy=cam.cy[ti], width=cam.width,
                 height=cam.height)
    on_dev = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=dev)
    data = TrainData(images=on_dev(images), sensor_depths=on_dev(depths),
                     mono_depths=on_dev(mono), normals=on_dev(normals),
                     masks=on_dev(masks))
    return sub, data
