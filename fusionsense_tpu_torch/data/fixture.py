"""Write a complete synthetic capture to disk in the capture data layout.

Counterpart of fusionsense_tpu/data/fixture.py, with the same on-disk
contract: transforms.json + images/ (8-bit png) + depths/ (16-bit mm png)
+ normals/ (npy, OpenGL camera frame) + masks/ + a seed ply + optionally
tactile/gelsight_transform.json. Ground-truth renders go through the port's
rasterizer on the caller's device (the card by default); files are written
through data/image_io.py.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from fusionsense_tpu_torch.data.image_io import write_png
from fusionsense_tpu_torch.data.synthetic import (
    ring_cameras, sphere_depth_normals, sphere_points,
)
from fusionsense_tpu_torch.device import resolve_device
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.gaussians.store import activated
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig, rasterize
from fusionsense_tpu_torch.utils.ply import write_pcd, write_ply

_GL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dirs(data_dir) -> Path:
    data_dir = Path(data_dir)
    (data_dir / "images").mkdir(parents=True, exist_ok=True)
    for sub in ("depths", "normals", "masks"):
        (data_dir / sub).mkdir(exist_ok=True)
    return data_dir


def _write_view(data_dir: Path, name: str, rgb, depth_mm: np.ndarray,
                nrm, mask: np.ndarray, w2c: np.ndarray):
    """One frame's image, depth, OpenGL camera-frame normals and mask."""
    write_png(data_dir / "images" / name,
              _np(torch.clamp(rgb, 0, 1) * 255).astype(np.uint8))
    write_png(data_dir / "depths" / name, depth_mm)
    n_cam = (_np(nrm) @ w2c[:3, :3].T) * np.array([1, -1, -1.0])
    np.save(data_dir / "normals" / (name + ".npy"), n_cam)
    write_png(data_dir / "masks" / name, (mask * 255).astype(np.uint8))


def _frame(name: str, c2w_gl: np.ndarray, focal, width, height) -> dict:
    return {
        "file_path": f"images/{name}",
        "depth_file_path": f"depths/{name}",
        "normal_file_path": f"normals/{name}.npy",
        "mask_file_path": f"masks/{name}",
        "transform_matrix": c2w_gl.tolist(),
        "fl_x": focal, "fl_y": focal,
        "cx": width / 2, "cy": height / 2, "w": width, "h": height,
    }


def _meta(frames, n_views) -> dict:
    return {
        "frames": frames,
        "ply_file_path": "seed.ply",
        "train_filenames": [f"images/frame_{i:05d}.png"
                            for i in range(n_views - 1)],
        "test_filenames": [f"images/frame_{n_views - 1:05d}.png"],
    }


def _write_touch(data_dir: Path, anchor_x: float):
    """One 21 x 21 sensor-grid patch whose -z normal faces +x, anchored at
    (anchor_x, 0, 0)."""
    tdir = data_dir / "tactile"
    tdir.mkdir(exist_ok=True)
    grid = np.stack(np.meshgrid(np.arange(-10, 11), np.arange(-10, 11)),
                    -1).reshape(-1, 2) * 10.0   # sensor units
    sensor_pts = np.concatenate([grid, np.zeros((len(grid), 1))], -1)
    write_pcd(tdir / "patch_0.pcd", sensor_pts.astype(np.float32),
              extra={"normal_x": np.zeros(len(grid), np.float32),
                     "normal_y": np.zeros(len(grid), np.float32)})
    T = np.eye(4)
    T[:3, :3] = np.array([[0, 0, -1.0], [0, 1.0, 0], [1.0, 0, 0]]).T
    T[:3, 3] = [anchor_x, 0.0, 0.0]
    with open(tdir / "gelsight_transform.json", "w") as f:
        json.dump({"gel_scale": 6.34e-5,
                   "frames": [{"file_path": "patch_0.pcd",
                               "transform_matrix": T.tolist()}]}, f)


def _gt_renderer(pts, rgb, normals, capacity, init_opacity, tile_capacity):
    gt = init_from_points(pts, rgb, capacity=capacity, sh_degree=1,
                          seed_normals=normals, init_opacity=init_opacity)
    rcfg = RasterizeConfig(tile_size=16, tile_capacity=tile_capacity,
                           max_tiles_per_gaussian=16, tile_chunk=16,
                           sh_degree=1)
    m, q, s, o, c = activated(gt)

    def render(cam):
        with torch.no_grad():
            return rasterize(m, q, s, o, c, cam, rcfg, device=m.device).rgb
    return render


def write_synthetic_scene(data_dir, n_views: int = 6, width: int = 96,
                          height: int = 72, focal: float = 85.0,
                          radius: float = 0.4, n_gt: int = 1500,
                          with_touches: bool = False, seed: int = 0,
                          device=None):
    """The textured sphere, rendered with the tiled rasterizer; depth,
    normals and masks analytic. Returns data_dir."""
    dev = resolve_device(device)
    data_dir = _dirs(data_dir)
    cams = ring_cameras(n_views=n_views, width=width, height_px=height,
                        focal=focal, device=dev)
    pts, rgb, normals = sphere_points(n=n_gt, radius=radius, seed=seed,
                                      device=dev)
    render = _gt_renderer(pts, rgb, normals, max(2048, n_gt * 2), 0.95, 128)
    frames = []
    for i in range(n_views):
        cam_i = cams.index(i)
        depth, nrm, mask = sphere_depth_normals(cam_i, radius=radius)
        name = f"frame_{i:05d}.png"
        w2c = _np(cam_i.viewmat)
        _write_view(data_dir, name, render(cam_i),
                    (_np(depth) * 1000).astype(np.uint16), nrm, _np(mask), w2c)
        frames.append(_frame(name, np.linalg.inv(w2c) @ _GL_FLIP, focal,
                             width, height))

    # seed pcd: subsampled noisy GT surface
    rng = np.random.RandomState(seed)
    seed_pts = _np(pts)[:: max(1, n_gt // 500)]
    seed_pts = seed_pts + rng.randn(*seed_pts.shape).astype(np.float32) * 0.01
    write_ply(data_dir / "seed.ply", seed_pts,
              colors=_np(rgb)[:: max(1, n_gt // 500)])
    if with_touches:
        _write_touch(data_dir, radius)   # the sphere's +x pole
    with open(data_dir / "transforms.json", "w") as f:
        json.dump(_meta(frames, n_views), f)
    return data_dir


def write_blob_scene(data_dir, n_views: int = 9, width: int = 128,
                     height: int = 96, focal: float = 110.0, base: float = 0.4,
                     n_gt: int = 4000, depth_noise: float = 0.004,
                     with_touches: bool = True, seed: int = 0,
                     n_seed_pts: int = 600, device=None):
    """Realistic-capture fixture: 9 posed views of a bumpy star-convex
    object with procedural texture, noisy 16-bit sensor depth, masks, a
    sparse noisy seed pcd, one tactile patch, and the dense GT surface
    points (`gt_points.ply`)."""
    from fusionsense_tpu_torch.data.synthetic import (
        _blob_radius, blob_depth_normals, blob_points,
    )

    dev = resolve_device(device)
    data_dir = _dirs(data_dir)
    cams = ring_cameras(n_views=n_views, width=width, height_px=height,
                        focal=focal, device=dev)
    pts, rgb, normals = blob_points(n=n_gt, base=base, seed=seed, device=dev)
    render = _gt_renderer(pts, rgb, normals, max(4096, n_gt * 2), 0.97, 192)

    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n_views):
        cam_i = cams.index(i)
        depth, nrm, mask = blob_depth_normals(cam_i, base=base)
        name = f"frame_{i:05d}.png"
        # sensor-like depth: multiplicative speckle + mm quantization
        d = _np(depth)
        d_noisy = d * (1.0 + depth_noise * rng.randn(*d.shape))
        d_mm = np.clip(d_noisy * 1000, 0, 65535).astype(np.uint16)
        w2c = _np(cam_i.viewmat)
        _write_view(data_dir, name, render(cam_i), d_mm, nrm, _np(mask), w2c)
        frames.append(_frame(name, np.linalg.inv(w2c) @ _GL_FLIP, focal,
                             width, height))

    # sparse noisy seed pcd (what a 9-view SfM/backprojection would give)
    step = max(1, n_gt // n_seed_pts)
    pts_np, rgb_np = _np(pts), _np(rgb)
    seed_pts = pts_np[::step]
    seed_pts = seed_pts + rng.randn(*seed_pts.shape).astype(np.float32) * 0.012
    write_ply(data_dir / "seed.ply", seed_pts, colors=rgb_np[::step])
    write_ply(data_dir / "gt_points.ply", pts_np, colors=rgb_np)
    if with_touches:   # at the blob's +x surface point
        r_x = float(_blob_radius(torch.tensor([1.0, 0.0, 0.0]), base))
        _write_touch(data_dir, r_x)
    with open(data_dir / "transforms.json", "w") as f:
        json.dump(_meta(frames, n_views), f)
    return data_dir


def _imperfect_mask(mask: np.ndarray, view_idx: int, rng) -> np.ndarray:
    """Segmentation-like masks: dilate even views, erode odd views by about
    a pixel, and punch one small hole inside the object."""
    m = mask > 0.5
    shift = np.zeros_like(m)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shift |= np.roll(np.roll(m, dy, 0), dx, 1)
    if view_idx % 2 == 0:
        m = shift
    else:
        er = np.ones_like(m)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                er &= np.roll(np.roll(m, dy, 0), dx, 1)
        m = er
    ys, xs = np.nonzero(m)
    if len(ys) > 50:
        k = rng.randint(len(ys))
        y0, x0 = ys[k], xs[k]
        m[max(0, y0 - 2):y0 + 2, max(0, x0 - 2):x0 + 2] = False
    return m.astype(np.float32)


def write_hard_scene(data_dir, n_views: int = 9, width: int = 128,
                     height: int = 96, focal: float = 110.0, base: float = 0.4,
                     depth_noise: float = 0.004,
                     pose_rot_noise: float = 0.005,
                     pose_trans_noise: float = 0.002, seed: int = 0,
                     n_seed_pts: int = 700, device=None):
    """Hard fixture: a non-convex object (torus handle + concave dent),
    strong view-dependent specular shading (images shaded analytically, not
    splat-rendered), a checkered background with its depth in the sensor
    maps, imperfect masks, noisy 16-bit depth, and pose noise in
    transforms.json (the images use the true poses)."""
    from fusionsense_tpu_torch.data.synthetic import (
        hard_depth_normals, hard_points, shade_hard_view,
    )

    dev = resolve_device(device)
    data_dir = _dirs(data_dir)
    cams = ring_cameras(n_views=n_views, width=width, height_px=height,
                        focal=focal, device=dev)
    rng = np.random.RandomState(seed)
    frames = []
    for i in range(n_views):
        cam_i = cams.index(i)
        rgb, depth, mask = shade_hard_view(cam_i, base=base)
        _, nrm, _ = hard_depth_normals(cam_i, base=base)
        name = f"frame_{i:05d}.png"
        d = _np(depth)
        d_noisy = d * (1.0 + depth_noise * rng.randn(*d.shape))
        d_mm = np.clip(d_noisy * 1000, 0, 65535).astype(np.uint16)
        w2c = _np(cam_i.viewmat)
        m = _imperfect_mask(_np(mask), i, rng)
        _write_view(data_dir, name, rgb, d_mm, nrm, m, w2c)

        # calibrated pose error: the poses the pipeline sees are slightly
        # off the poses the capture was rendered with
        c2w = np.linalg.inv(w2c)
        dr = pose_rot_noise * rng.randn(3)
        K = np.array([[0, -dr[2], dr[1]], [dr[2], 0, -dr[0]],
                      [-dr[1], dr[0], 0]])
        R_noise = np.eye(3) + K + 0.5 * K @ K       # ~exp(K)
        c2w_noisy = c2w.copy()
        c2w_noisy[:3, :3] = R_noise @ c2w[:3, :3]
        c2w_noisy[:3, 3] += pose_trans_noise * rng.randn(3)
        frames.append(_frame(name, c2w_noisy @ _GL_FLIP, focal, width,
                             height))

    pts, cols, _ = hard_points(n=6000, base=base, seed=seed, device=dev)
    pts_np, cols_np = _np(pts), _np(cols)
    k = rng.choice(len(pts_np), size=min(n_seed_pts, len(pts_np)),
                   replace=False)
    seed_pts = pts_np[k] + rng.randn(len(k), 3).astype(np.float32) * 0.012
    write_ply(data_dir / "seed.ply", seed_pts, colors=cols_np[k])
    write_ply(data_dir / "gt_points.ply", pts_np, colors=cols_np)
    with open(data_dir / "transforms.json", "w") as f:
        json.dump(_meta(frames, n_views), f)
    return data_dir
