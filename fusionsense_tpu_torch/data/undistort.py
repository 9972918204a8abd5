"""Image undistortion (OPENCV radial-tangential + OPENCV_FISHEYE models).

Counterpart of fusionsense_tpu/data/undistort.py, kept as the port's own
copy. Undistortion is a one-time host preprocessing pass (numpy remap, no
cv2 dependency): for every undistorted output pixel, apply the forward
distortion model to find the source pixel and bilinear-sample. The cache
reads and writes its images through data/image_io.py.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _distort_opencv(x, y, params):
    """Normalized coords -> distorted normalized coords (k1 k2 p1 p2 [k3])."""
    k1, k2, p1, p2 = params[:4]
    k3 = params[4] if len(params) > 4 else 0.0
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _distort_fisheye(x, y, params):
    """OpenCV fisheye: theta_d = theta (1 + k1 th^2 + k2 th^4 + ...)."""
    k1, k2, k3, k4 = (list(params) + [0.0] * 4)[:4]
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
    return x * scale, y * scale


def undistort_image(img: np.ndarray, K: np.ndarray, params,
                    model: str = "OPENCV") -> np.ndarray:
    """img (H, W[, C]); K (3, 3); returns same-shape undistorted image."""
    H, W = img.shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs = (np.arange(W, dtype=np.float64) - cx) / fx
    ys = (np.arange(H, dtype=np.float64) - cy) / fy
    gx, gy = np.meshgrid(xs, ys)
    if model in ("OPENCV", "FULL_OPENCV", "RADIAL", "SIMPLE_RADIAL"):
        if model == "SIMPLE_RADIAL":
            params = [params[0], 0.0, 0.0, 0.0]
        elif model == "RADIAL":
            params = [params[0], params[1], 0.0, 0.0]
        xd, yd = _distort_opencv(gx, gy, np.asarray(params, np.float64))
    elif model == "OPENCV_FISHEYE":
        xd, yd = _distort_fisheye(gx, gy, np.asarray(params, np.float64))
    else:
        raise ValueError(f"unsupported distortion model {model}")
    src_x = xd * fx + cx
    src_y = yd * fy + cy

    x0 = np.clip(np.floor(src_x).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(src_y).astype(np.int64), 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    fx_ = np.clip(src_x - x0, 0, 1)
    fy_ = np.clip(src_y - y0, 0, 1)
    if img.ndim == 3:
        fx_, fy_ = fx_[..., None], fy_[..., None]
    a = img[y0, x0].astype(np.float64)
    b = img[y0, x1].astype(np.float64)
    c = img[y1, x0].astype(np.float64)
    d = img[y1, x1].astype(np.float64)
    out = (a * (1 - fx_) * (1 - fy_) + b * fx_ * (1 - fy_)
           + c * (1 - fx_) * fy_ + d * fx_ * fy_)
    inside = ((src_x >= 0) & (src_x <= W - 1)
              & (src_y >= 0) & (src_y <= H - 1))
    if img.ndim == 3:
        inside = inside[..., None]
    out = np.where(inside, out, 0.0)
    return out.astype(img.dtype) if np.issubdtype(img.dtype, np.integer) \
        else out.astype(img.dtype)


def undistort_to_cache(image_paths, K: np.ndarray, params, model: str,
                       cache_dir) -> list[Path]:
    """One-time preprocessing: undistort every image into cache_dir (skips
    files already present). Returns the new paths."""
    from fusionsense_tpu_torch.data.image_io import read_image, write_png

    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    out_paths = []
    for p in image_paths:
        p = Path(p)
        dst = cache_dir / p.name
        if dst.suffix.lower() != ".png":   # the port writes PNG only
            dst = dst.with_suffix(".png")
        if not dst.exists():
            write_png(dst, undistort_image(read_image(p), K, params, model))
        out_paths.append(dst)
    return out_paths
