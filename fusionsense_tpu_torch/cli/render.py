"""fs-render in the port: RGB, depth and normal images (or an orbit video)
from a checkpoint.

    python -m fusionsense_tpu_torch.cli.render spiral --checkpoint <ckpt> --data <scene>

The flags, their defaults and choices are those of fusionsense_tpu's
fs-render (the reference's ns-render fork, scripts/render_video.py:951-964:
camera-path / interpolate / spiral / dataset), restoring the Gaussians
from an fs-train checkpoint of the port and rendering them at the SH degree
it holds. The renders run on the card; `--backend flat` renders through
K1, `--backend pallas` through K3. `--video` needs imageio, imported only
in that branch.
"""
from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("fs-render", description=__doc__)
    p.add_argument("mode",
                   choices=["dataset", "interpolate", "spiral",
                            "camera-path"])
    p.add_argument("--camera-path", default=None,
                   help="nerfstudio-style camera_path.json for camera-path"
                        " mode (keyframed c2w matrices)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--output-dir", default="renders")
    p.add_argument("--split", default="train")
    p.add_argument("--n-frames", type=int, default=60,
                   help="frames for interpolate/spiral")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--video", action="store_true", help="also write mp4")
    p.add_argument("--backend", choices=["jax", "pallas", "flat"],
                   default="jax")
    return p


def _save_image(path, arr, normalize=False):
    from PIL import Image

    from fusionsense_tpu_torch.device import host

    arr = host(arr)
    if normalize:
        lo, hi = arr.min(), arr.max()
        arr = (arr - lo) / max(hi - lo, 1e-8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)


def _batched_camera(mats, fx, fy, ref_camera):
    """n world-to-camera matrices at the reference camera's image size and
    device, principal point at the image centre."""
    from fusionsense_tpu_torch.core.cameras import make_camera

    W, H = ref_camera.width, ref_camera.height
    ones = np.ones((len(mats),), np.float32)
    return make_camera(np.stack(mats).astype(np.float32), fx * ones,
                       fy * ones, W / 2 * ones, H / 2 * ones, W, H,
                       device=ref_camera.device)


def _orbit_cameras(camera, n_frames, spiral=False):
    """Interpolated orbit around the scene center from the capture ring."""
    from fusionsense_tpu_torch.data.synthetic import look_at_w2c
    from fusionsense_tpu_torch.device import host

    origins = host(camera.origin)
    center = np.zeros(3)
    r = float(np.linalg.norm(origins[:, :2], axis=1).mean())
    z = float(origins[:, 2].mean())
    mats = []
    for i in range(n_frames):
        a = 2 * math.pi * i / n_frames
        zz = z + (0.3 * z * math.sin(4 * math.pi * i / n_frames) if spiral else 0)
        eye = np.array([r * math.cos(a), r * math.sin(a), zz])
        mats.append(look_at_w2c(eye, center))
    fx = float(host(camera.fx).mean())
    return _batched_camera(mats, fx, fx, camera)


def _interpolate_cameras(camera, n_frames):
    """Normalised-lerp / linear interpolation through the dataset poses in
    order (the reference's RenderInterpolated, scripts/render_video.py:639)."""
    import torch

    from fusionsense_tpu_torch.core.transforms import (
        quat_to_rotmat, rotmat_to_quat,
    )
    from fusionsense_tpu_torch.device import host

    c2w = np.linalg.inv(host(camera.viewmat))
    n_key = c2w.shape[0]
    quats = host(rotmat_to_quat(torch.from_numpy(c2w[:, :3, :3])))
    trans = c2w[:, :3, 3]
    mats = []
    for i in range(n_frames):
        t = i * (n_key - 1) / max(n_frames - 1, 1)
        k = min(int(t), n_key - 2)
        f = t - k
        q0, q1 = quats[k], quats[k + 1]
        if np.dot(q0, q1) < 0:
            q1 = -q1
        q = (1 - f) * q0 + f * q1           # nlerp (fine for close keyframes)
        q = q / np.linalg.norm(q)
        R = host(quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)))
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = (1 - f) * trans[k] + f * trans[k + 1]
        mats.append(np.linalg.inv(m))
    fx = float(host(camera.fx).mean())
    return _batched_camera(mats, fx, fx, camera)


def _load_camera_path(path, ref_camera, scene):
    """nerfstudio camera_path.json -> batched Camera (the reference's
    camera-path rendering mode, scripts/render_video.py:490)."""
    import json

    with open(path) as f:
        meta = json.load(f)
    frames = meta.get("camera_path", meta.get("keyframes", []))
    mats, fovs = [], []
    for fr in frames:
        c2w = np.asarray(fr["camera_to_world"], np.float64).reshape(4, 4)
        # camera paths are in the raw capture frame (OpenGL): normalize +
        # convert like the dataparser
        c2w[:3, 3] = (c2w[:3, 3] + scene.translate) * scene.scale
        c2w = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])
        mats.append(np.linalg.inv(c2w))
        fovs.append(float(fr.get("fov", 60.0)))
    H = ref_camera.height
    fy = np.array([0.5 * H / math.tan(math.radians(f) / 2) for f in fovs],
                  np.float32)
    return _batched_camera(mats, fy, fy, ref_camera)


def render_inputs(args, device=None):
    """The Gaussians of args.checkpoint and the batched camera of args.mode
    (dataset mode on the train split at the checkpoint's optimised poses),
    on `device` (the card by default)."""
    from fusionsense_tpu_torch.core.transforms import apply_se3_delta
    from fusionsense_tpu_torch.data.dataparser import (
        DataParserConfig, load_train_data, parse_transforms,
    )
    from fusionsense_tpu_torch.device import resolve_device
    from fusionsense_tpu_torch.train.checkpoint import load_for_inference

    dev = resolve_device(device)
    gaussians, _, cam_state = load_for_inference(args.checkpoint, device=dev)
    dcfg = DataParserConfig(data_dir=args.data)
    scene = parse_transforms(dcfg, device=dev)
    camera, _ = load_train_data(scene, dcfg, args.split)
    # dataset mode on the train split renders the poses the model was
    # optimized against (learned SE3 deltas); synthetic paths (spiral/
    # interpolate/camera-path) are novel views — no deltas exist for them
    if (args.mode == "dataset" and args.split == "train"
            and cam_state is not None):
        d = cam_state[0]
        if d.shape[0] == camera.viewmat.shape[0] and bool((d != 0).any()):
            camera = camera.replace(viewmat=apply_se3_delta(camera.viewmat, d))
    if args.mode == "camera-path":
        camera = _load_camera_path(args.camera_path, camera, scene)
    elif args.mode == "interpolate":
        camera = _interpolate_cameras(camera, args.n_frames)
    elif args.mode == "spiral":
        camera = _orbit_cameras(camera, args.n_frames, spiral=True)
    return gaussians, camera


def main(argv=None, device=None):
    """Parse argv and render every frame into --output-dir/{rgb,depth,
    normal}; returns the number of frames. `device` is where the renders
    run (the card by default; the tests pass "cpu")."""
    args = build_parser().parse_args(argv)

    from fusionsense_tpu_torch.device import host
    from fusionsense_tpu_torch.eval.evaluator import make_render_fn
    from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
    from fusionsense_tpu_torch.train.checkpoint import checkpoint_sh_degree

    gaussians, camera = render_inputs(args, device)
    n = camera.viewmat.shape[0]

    out = Path(args.output_dir)
    for sub in ("rgb", "depth", "normal"):
        (out / sub).mkdir(parents=True, exist_ok=True)

    render = make_render_fn(
        RasterizeConfig(backend=args.backend,
                        sh_degree=checkpoint_sh_degree(gaussians)), camera)
    frames = []
    for i in range(n):
        o = render(gaussians, i)
        rgb = host(o.rgb)
        _save_image(out / "rgb" / f"{i:05d}.png", rgb)
        _save_image(out / "depth" / f"{i:05d}.png", o.depth, normalize=True)
        _save_image(out / "normal" / f"{i:05d}.png", host(o.normal) * 0.5 + 0.5)
        frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))

    if args.video:
        import imageio

        imageio.mimwrite(out / "orbit.mp4", frames, fps=args.fps)
    print(f"rendered {n} frames -> {out}")
    return n


if __name__ == "__main__":
    main()
