"""Anchor grids for the 5 FPN levels.

The port's copy of fusionsense_tpu/detection/anchors.py (numpy).

Behavioral contract: PartSlip/GLIP/maskrcnn_benchmark/modeling/rpn/
anchor_generator.py (make_anchor_generator_complex, :157-181) with the
Swin-L config: one anchor per location, sizes (64,128,256,512,1024) at
strides (8,16,32,64,128), aspect ratio 1.0 — a size*size square cell
anchor centered at ((stride-1)/2, (stride-1)/2), shifted over the grid.
"""
from __future__ import annotations

import numpy as np

SIZES = (64, 128, 256, 512, 1024)
STRIDES = (8, 16, 32, 64, 128)


def level_anchors(h: int, w: int, stride: int, size: int) -> np.ndarray:
    """(h*w, 4) xyxy anchors, row-major over the grid."""
    ctr = (stride - 1) / 2.0
    half = (size - 1) / 2.0
    base = np.array([ctr - half, ctr - half, ctr + half, ctr + half],
                    np.float32)
    sx = np.arange(w, dtype=np.float32) * stride
    sy = np.arange(h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 4)
    return shifts + base[None]


def pyramid_anchors(level_shapes: list[tuple[int, int]]) -> list[np.ndarray]:
    return [level_anchors(h, w, STRIDES[i], SIZES[i])
            for i, (h, w) in enumerate(level_shapes)]
