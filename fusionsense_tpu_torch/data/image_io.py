"""Image files for the port's data path: Pillow for image formats, numpy
for .npy arrays.

Pillow is imported when a file is read or written, never when this module
is imported, so the rest of the port imports without it; where it is
missing, a read or a write raises an ImportError naming the file.
`read_image` returns what `np.asarray(PIL.Image.open(path))` gives, and
`load_image` is the JAX dataparser's `_load_image` (Pillow's BILINEAR
downscale by an integer factor).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _pillow(path):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading or writing images needs Pillow, "
                          f"which is not installed") from e
    return Image


def read_image(path) -> np.ndarray:
    """What np.asarray(PIL.Image.open(path)) gives; .npy files load as
    saved."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.load(path)
    return np.asarray(_pillow(path).open(path))


def write_png(path, arr: np.ndarray) -> None:
    """Save uint8 (H, W[, C]) or uint16 (H, W) as Image.fromarray does
    (uint16 as 16-bit gray)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _pillow(path).fromarray(np.asarray(arr)).save(path)


def image_size(path) -> tuple[int, int]:
    """(width, height) of an image file."""
    return _pillow(path).open(path).size


def load_image(path, downscale: int = 1) -> np.ndarray:
    """An image file as an (H, W, C) array, downscaled by an integer factor
    with Pillow's bilinear filter (the JAX dataparser's _load_image)."""
    Image = _pillow(path)
    img = Image.open(path)
    if downscale > 1:
        img = img.resize((img.width // downscale, img.height // downscale),
                         Image.BILINEAR)
    arr = np.asarray(img)
    return arr[..., None] if arr.ndim == 2 else arr
