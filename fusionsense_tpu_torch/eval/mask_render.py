"""Mask-renderer helper: white out the background of rendered images.

Counterpart of fusionsense_tpu/eval/mask_render.py (the reference's
eval_utils/mask_rendering.py:1-30, with its hardcoded paths as
arguments): masked renders for the masked PSNR/SSIM protocol. Host numpy;
Pillow is imported when files are read or written.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def mask_image(rgb: np.ndarray, mask: np.ndarray,
               background: float = 1.0) -> np.ndarray:
    """(H, W, 3) x (H, W) -> background-filled render."""
    m = (np.asarray(mask) > 0.5)[..., None]
    return np.where(m, rgb, background).astype(rgb.dtype)


def mask_images(render_dir, mask_dir, out_dir, background: float = 1.0):
    """Apply masks to every image in render_dir (matched by filename);
    returns how many were written."""
    from PIL import Image

    render_dir, mask_dir, out_dir = Path(render_dir), Path(mask_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for p in sorted(render_dir.iterdir()):
        mp = mask_dir / p.name
        if not mp.exists():
            continue
        rgb = np.asarray(Image.open(p)).astype(np.float32) / 255.0
        mask = np.asarray(Image.open(mp).convert("L")).astype(np.float32) / 255.0
        out = mask_image(rgb[..., :3], mask, background)
        Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8)).save(
            out_dir / p.name)
        count += 1
    return count
