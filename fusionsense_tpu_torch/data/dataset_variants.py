"""Benchmark-dataset layout adapters -> ParsedScene.

Counterpart of fusionsense_tpu/data/dataset_variants.py. Each layout
adapts into the same ParsedScene structure consumed by the trainer, through
one registry:

    scene = parse_dataset("replica", DataParserConfig(data_dir=...))

- "nerfstudio": transforms.json (data/dataparser.py)
- "replica":   traj.txt (flattened 4x4 c2w per line) + results/frame*.jpg
               + results/depth*.png at scale 1/6553.5 (reference
               replica_dataparser conventions)
- "mushroom":  <sensor>/long_capture/transforms.json + depth dirs
               (reference mushroom_dataparser; kinect/iphone sensors)
- "colmap":    COLMAP text model + images dir (+ optional depths/normals
               dirs) — covers CoolerMap/ScanNet++-style exports
- "sdfstudio": meta_data.json frames with camtoworld/intrinsics entries
               (reference gsdfstudio_dataparser)
- "nrgbd":     trajectory.txt + images/ + depth/ (neural-RGBD layout)
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import make_camera
from fusionsense_tpu_torch.data.dataparser import (
    DataParserConfig, ParsedScene, natsort_key, parse_transforms,
)
from fusionsense_tpu_torch.data.image_io import image_size

_GL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def _normalize_poses(c2w: np.ndarray, cfg: DataParserConfig):
    origins = c2w[:, :3, 3]
    translate = -origins.mean(axis=0) if cfg.auto_center else np.zeros(3)
    centered = origins + translate
    scale = cfg.scale_factor
    if cfg.auto_scale:
        scale = cfg.scale_factor / max(float(np.abs(centered).max()), 1e-8)
    c2w = c2w.copy()
    c2w[:, :3, 3] = centered * scale
    return c2w, translate, scale


def _build_scene(c2w_cv, fx, fy, cx, cy, width, height, image_paths,
                 depth_paths, cfg, normal_paths=None, mask_paths=None,
                 mono_depth_paths=None, test_every: int = 8,
                 depth_unit_scale=None, device=None):
    c2w_cv, translate, scale = _normalize_poses(np.asarray(c2w_cv), cfg)
    w2c = np.linalg.inv(c2w_cv).astype(np.float32)
    n = len(image_paths)
    ones = np.ones((n,), np.float32)
    cameras = make_camera(w2c, fx * ones, fy * ones, cx * ones, cy * ones,
                          width, height, device=device)
    idx = np.arange(n, dtype=np.int32)
    test = idx[::test_every] if test_every else np.array([], np.int32)
    train = np.array([i for i in idx if i not in set(test.tolist())], np.int32)
    none = [None] * n
    return ParsedScene(
        cameras=cameras, image_paths=list(image_paths),
        depth_paths=list(depth_paths) if depth_paths else none,
        mono_depth_paths=list(mono_depth_paths) if mono_depth_paths else none,
        normal_paths=list(normal_paths) if normal_paths else none,
        mask_paths=list(mask_paths) if mask_paths else none,
        train_idx=train, val_idx=test, test_idx=test,
        translate=translate, scale=scale,
        depth_unit_scale=depth_unit_scale,
    )


# ---------------------------------------------------------------- replica --

REPLICA_FOCAL = dict(fx=600.0, fy=600.0, cx=599.5, cy=339.5, w=1200, h=680)
REPLICA_DEPTH_SCALE = 1.0 / 6553.5


def parse_replica(cfg: DataParserConfig, test_every: int = 8,
                  device=None) -> ParsedScene:
    d = Path(cfg.data_dir)
    traj = np.loadtxt(d / "traj.txt").reshape(-1, 4, 4)   # c2w OpenCV
    frames = sorted((d / "results").glob("frame*.jpg"),
                    key=lambda p: natsort_key(p.name))
    depths = sorted((d / "results").glob("depth*.png"),
                    key=lambda p: natsort_key(p.name))
    n = min(len(frames), len(traj))
    fp = REPLICA_FOCAL
    return _build_scene(
        traj[:n], fp["fx"], fp["fy"], fp["cx"], fp["cy"], fp["w"], fp["h"],
        frames[:n], depths[:n] if depths else None, cfg,
        test_every=test_every, depth_unit_scale=REPLICA_DEPTH_SCALE,
        device=device)


# --------------------------------------------------------------- mushroom --

def _mushroom_fill_depths(scene: ParsedScene, base: Path,
                          use_faro: bool = False):
    """Sensor depth dir convention: depth/ next to images/; the faro
    reference scan (reference mushroom_dataparser.py:72-73,128-130) swaps
    in reference_depth/ when requested and present."""
    depth_dir = base / ("reference_depth" if use_faro else "depth")
    if not depth_dir.exists() and use_faro:
        raise FileNotFoundError(
            f"faro reference depths not found at {depth_dir} (the reference "
            "downloads them; this environment is air-gapped)")
    if depth_dir.exists() and all(p is None for p in scene.depth_paths):
        scene.depth_paths = [
            depth_dir / Path(p).with_suffix(".png").name
            for p in scene.image_paths]


def parse_mushroom(cfg: DataParserConfig, sensor: str = "kinect",
                   eval_mode: str = "within",
                   use_faro_depths: bool = False, device=None) -> ParsedScene:
    """MuSHRoom two-capture protocol: train on long_capture; eval 'within' = the long
    capture's held-out frames (test_filenames / every-10th), 'with' = the
    SHORT capture's frames evaluated against the long-capture model,
    'all' = both."""
    root = Path(cfg.data_dir) / sensor
    long_dir = root / "long_capture"
    sub = DataParserConfig(**{**cfg.__dict__, "data_dir": str(long_dir)})
    scene = parse_transforms(sub, device=device)
    _mushroom_fill_depths(scene, long_dir, use_faro_depths)
    if len(scene.test_idx) == 0:
        scene.test_idx = np.arange(len(scene.image_paths),
                                   dtype=np.int32)[::10]
        scene.train_idx = np.array(
            [i for i in range(len(scene.image_paths))
             if i not in set(scene.test_idx.tolist())], np.int32)

    short_dir = root / "short_capture"
    if eval_mode in ("with", "all") and short_dir.exists():
        ssub = DataParserConfig(**{**cfg.__dict__, "data_dir": str(short_dir),
                                   "auto_center": False, "auto_scale": False})
        short = parse_transforms(ssub, device=device)
        _mushroom_fill_depths(short, short_dir, use_faro_depths)
        n_long = len(scene.image_paths)
        # short-capture poses live in the same world frame; apply the long
        # capture's normalization so both splits share scene coords
        vm = short.cameras.viewmat.cpu().numpy().copy()
        c2w = np.linalg.inv(vm)
        c2w[:, :3, 3] = (c2w[:, :3, 3] + scene.translate) * scene.scale
        short_vm = torch.as_tensor(np.linalg.inv(c2w).astype(np.float32),
                                   device=scene.cameras.device)
        cat = lambda a, b: torch.cat([a, b])  # noqa: E731
        scene.cameras = scene.cameras.replace(
            viewmat=cat(scene.cameras.viewmat, short_vm),
            fx=cat(scene.cameras.fx, short.cameras.fx),
            fy=cat(scene.cameras.fy, short.cameras.fy),
            cx=cat(scene.cameras.cx, short.cameras.cx),
            cy=cat(scene.cameras.cy, short.cameras.cy))
        scene.image_paths += short.image_paths
        scene.depth_paths += short.depth_paths
        scene.normal_paths += short.normal_paths
        scene.mask_paths += short.mask_paths
        scene.mono_depth_paths += short.mono_depth_paths
        short_idx = np.arange(n_long, n_long + len(short.image_paths),
                              dtype=np.int32)
        if eval_mode == "with":
            scene.test_idx = short_idx
        else:
            scene.test_idx = np.concatenate([scene.test_idx, short_idx])
        scene.val_idx = scene.test_idx
    return scene


# -------------------------------------------------------------- scannetpp --

def parse_scannetpp(cfg: DataParserConfig, sequence: str = "",
                    mode: str = "dslr", test_every: int = 8,
                    device=None) -> ParsedScene:
    """ScanNet++ layouts:
    - dslr:   <data>/<seq>/dslr/undistort_colmap/<seq>/{colmap, images,
              masks} (pre-undistorted COLMAP export) with the test split
              from <data>/<seq>/dslr/train_test_lists.json,
    - iphone: <data>/<seq>/iphone/{colmap, rgb, rgb_masks, depth}.
    Frames with COLMAP OPENCV/OPENCV_FISHEYE distortion parameters are
    undistorted once into an `undistorted/` cache (data/undistort.py).
    """
    from fusionsense_tpu_torch.data.colmap import (
        read_cameras_txt, read_images_txt,
    )
    from fusionsense_tpu_torch.data.undistort import undistort_to_cache

    root = Path(cfg.data_dir)
    if sequence:
        root = root / sequence
    base = root / mode
    if mode == "dslr":
        inner = base / "undistort_colmap"
        if inner.exists():
            seqs = [p for p in inner.iterdir() if p.is_dir()]
            inner = inner / sequence if (inner / sequence).exists() else seqs[0]
        else:
            inner = base
        colmap_dir = inner / "colmap"
        images_dir = inner / "images"
        mask_dir = inner / "masks"
        depth_dir = inner / "depth"
    else:
        colmap_dir = base / "colmap"
        images_dir = base / "rgb"
        mask_dir = base / "rgb_masks"
        depth_dir = base / "depth"

    cams = read_cameras_txt(colmap_dir / "cameras.txt")
    images = read_images_txt(colmap_dir / "images.txt")
    cam0 = cams[images[0]["camera_id"]]
    fx, fy, cx, cy = cam0.intrinsics()
    image_paths = [images_dir / im["name"] for im in images]

    # undistort once if the camera model carries distortion
    dist = np.asarray(cam0.params[4:], np.float64)
    if len(dist) and np.any(np.abs(dist) > 1e-12):
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        model = ("OPENCV_FISHEYE" if cam0.model == "OPENCV_FISHEYE"
                 else cam0.model)
        image_paths = undistort_to_cache(image_paths, K, dist, model,
                                         images_dir.parent / "undistorted")

    c2w = np.stack([np.linalg.inv(im["w2c"]) for im in images])
    depth_paths = ([depth_dir / Path(im["name"]).with_suffix(".png").name
                    for im in images] if depth_dir.exists() else None)
    mask_paths = ([mask_dir / Path(im["name"]).name for im in images]
                  if mask_dir.exists() else None)
    scene = _build_scene(c2w, fx, fy, cx, cy, cam0.width, cam0.height,
                         image_paths, depth_paths, cfg,
                         mask_paths=mask_paths, test_every=test_every,
                         device=device)

    # dslr protocol: explicit test list
    split_file = base / "train_test_lists.json"
    if split_file.exists():
        with open(split_file) as f:
            lists = json.load(f)
        test_names = set(lists.get("test", []))
        names = [im["name"] for im in images]
        test = np.array([i for i, n in enumerate(names) if n in test_names],
                        np.int32)
        train = np.array([i for i, n in enumerate(names)
                          if n not in test_names], np.int32)
        scene.train_idx, scene.test_idx, scene.val_idx = train, test, test
    return scene


# ----------------------------------------------------------------- colmap --

def parse_colmap(cfg: DataParserConfig, images_dir: str = "images",
                 model_dir: str = "sparse/0",
                 test_every: int = 8, device=None) -> ParsedScene:
    from fusionsense_tpu_torch.data.colmap import (
        read_cameras_txt, read_images_txt, read_points3d_txt,
    )

    d = Path(cfg.data_dir)
    model = d / model_dir
    cams = read_cameras_txt(model / "cameras.txt")
    images = read_images_txt(model / "images.txt")
    cam0 = cams[images[0]["camera_id"]]
    fx, fy, cx, cy = cam0.intrinsics()
    c2w = np.stack([np.linalg.inv(im["w2c"]) for im in images])
    image_paths = [d / images_dir / im["name"] for im in images]

    scene = _build_scene(c2w, fx, fy, cx, cy, cam0.width, cam0.height,
                         image_paths, None, cfg, test_every=test_every,
                         device=device)
    pts_file = model / "points3D.txt"
    if pts_file.exists():
        pts, cols = read_points3d_txt(pts_file)
        scene.seed_points = ((pts + scene.translate) * scene.scale).astype(
            np.float32)
        scene.seed_colors = cols
    return scene


# -------------------------------------------------------------- sdfstudio --

def parse_sdfstudio(cfg: DataParserConfig, test_every: int = 8,
                    device=None) -> ParsedScene:
    d = Path(cfg.data_dir)
    with open(d / "meta_data.json") as f:
        meta = json.load(f)
    frames = meta["frames"]
    c2w = []
    image_paths, depth_paths, normal_paths = [], [], []
    K = None
    for fr in frames:
        mat = np.asarray(fr["camtoworld"], np.float64)
        c2w.append(mat)   # sdfstudio stores OpenCV camera-to-world
        K = np.asarray(fr.get("intrinsics", meta.get("intrinsics")))
        image_paths.append(d / fr["rgb_path"])
        depth_paths.append(
            d / fr["sensor_depth_path"] if "sensor_depth_path" in fr else None)
        normal_paths.append(
            d / fr["normal_path"] if "normal_path" in fr else None)
    h = int(meta.get("height", meta.get("h", 0))
            or image_size(image_paths[0])[1])
    w = int(meta.get("width", meta.get("w", 0))
            or image_size(image_paths[0])[0])
    return _build_scene(
        np.stack(c2w), K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h,
        image_paths, depth_paths if any(depth_paths) else None, cfg,
        normal_paths=normal_paths if any(normal_paths) else None,
        test_every=test_every, device=device)


# ------------------------------------------------------------------ nrgbd --

def parse_nrgbd(cfg: DataParserConfig, test_every: int = 8,
                device=None) -> ParsedScene:
    d = Path(cfg.data_dir)
    traj = np.loadtxt(d / "trajectory.txt")
    c2w = traj.reshape(-1, 4, 4)
    images = sorted((d / "images").glob("*.png"),
                    key=lambda p: natsort_key(p.name)) or sorted(
        (d / "images").glob("*.jpg"), key=lambda p: natsort_key(p.name))
    depths = sorted((d / "depth").glob("*.png"),
                    key=lambda p: natsort_key(p.name))
    n = min(len(images), len(c2w))
    w, h = image_size(images[0])
    focal = float(open(d / "focal.txt").read()) if (d / "focal.txt").exists() \
        else 0.5 * w / math.tan(0.5 * math.radians(90.0) / 2) * 0 + 554.26
    # NRGBD captures use OpenGL camera-to-world
    c2w = c2w[:n] @ _GL_FLIP
    return _build_scene(c2w, focal, focal, w / 2, h / 2, w, h,
                        images[:n], depths[:n] if depths else None, cfg,
                        test_every=test_every, device=device)


DATASETS = {
    "nerfstudio": lambda cfg, device=None, **kw: parse_transforms(
        cfg, device=device),
    "replica": parse_replica,
    "mushroom": parse_mushroom,
    "scannetpp": parse_scannetpp,
    "colmap": parse_colmap,
    "sdfstudio": parse_sdfstudio,
    "nrgbd": parse_nrgbd,
}


def parse_dataset(kind: str, cfg: DataParserConfig, **kw) -> ParsedScene:
    """Parse a layout of DATASETS; keyword arguments go to its parser (the
    cameras' `device`, the card by default, among them)."""
    if kind not in DATASETS:
        raise ValueError(f"unknown dataset kind {kind!r}; "
                         f"available: {sorted(DATASETS)}")
    return DATASETS[kind](cfg, **kw)
