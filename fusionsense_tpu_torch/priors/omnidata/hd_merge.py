"""HD patch pipeline for omnidata normals: overlapped 384x384 crops,
per-patch inference, rotation-aligned blending back to full resolution.

The port's copy of fusionsense_tpu/priors/omnidata/hd_merge.py, which is
host numpy: reference dn_splatter/scripts/normals_from_pretrain.py:238-283
(crop grid: stride-96 patches plus last-row/column and a centre patch),
:524-601 (best-fit SVD rotation between overlap regions, linear
cross-fade, renormalize), :656-780 (row-major x-alignment then y-alignment
then centre-patch alignment).

Pure numpy on (3, h, w) unit-normal arrays in [-1, 1]; file IO stays with
the caller.
"""
from __future__ import annotations

import numpy as np

IMAGE_SIZE = 384
STEP = 96


def crop_grid(H: int, W: int, image_size: int = IMAGE_SIZE,
              step: int = STEP):
    """Patch top-left corners: rows y + last, cols x + last, + centre."""
    x = (W - image_size) // step
    y = (H - image_size) // step
    crops = {}
    for j in range(y):
        for i in range(x):
            crops[(j, i)] = (j * step, i * step)
        crops[(j, x)] = (j * step, W - image_size)
    for i in range(x):
        crops[(y, i)] = (H - image_size, i * step)
    crops[(y, x)] = (H - image_size, W - image_size)
    crops["mid"] = (H // 2 - image_size // 2, W // 2 - image_size // 2)
    return x, y, crops


def best_fit_rotation(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Rotation R minimizing ||A R^T - B|| (reference
    best_fit_transform:524-545, rotation-only Kabsch)."""
    H = A.T @ B
    U, _S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[-1, :] *= -1
        R = Vt.T @ U.T
    return R


def _unit(n):
    return n / (np.linalg.norm(n, axis=0) + 1e-15)[None]


def align_normal_x(n1, n2, s1, e1, s2, e2):
    """Append n2 to n1's right, rotating n2 to agree on the overlap and
    cross-fading (reference align_normal_x:548-573)."""
    R = best_fit_rotation(n2[:, :, s2:e2].reshape(3, -1).T,
                          n1[:, :, s1:e1].reshape(3, -1).T)
    n2a = (R @ n2.reshape(3, -1)).reshape(n2.shape)
    out = np.ones((3, n1.shape[1], n1.shape[2] + n2.shape[2] - (e1 - s1)))
    out[:, :, :s1] = n1[:, :, :s1]
    out[:, :, n1.shape[2]:] = n2a[:, :, e2:]
    w = np.linspace(1, 0, e1 - s1)[None, None, :]
    out[:, :, s1:n1.shape[2]] = n1[:, :, s1:] * w + n2a[:, :, :e2] * (1 - w)
    return _unit(out)


def align_normal_y(n1, n2, s1, e1, s2, e2):
    R = best_fit_rotation(n2[:, s2:e2, :].reshape(3, -1).T,
                          n1[:, s1:e1, :].reshape(3, -1).T)
    n2a = (R @ n2.reshape(3, -1)).reshape(n2.shape)
    out = np.ones((3, n1.shape[1] + n2.shape[1] - (e1 - s1), n1.shape[2]))
    out[:, :s1, :] = n1[:, :s1, :]
    out[:, n1.shape[1]:, :] = n2a[:, e2:, :]
    w = np.linspace(1, 0, e1 - s1)[None, :, None]
    out[:, s1:n1.shape[1], :] = n1[:, s1:, :] * w + n2a[:, :e2, :] * (1 - w)
    return _unit(out)


def merge_patches(patches: dict, H: int, W: int,
                  image_size: int = IMAGE_SIZE,
                  step: int = STEP) -> np.ndarray:
    """patches[(j, i)] and patches["mid"]: (3, image_size, image_size)
    unit normals -> (3, H, W) merged map (reference merge_patches:656-780:
    x-align each row, y-align rows, rotate everything onto the centre
    patch's frame)."""
    x = (W - image_size) // step
    y = (H - image_size) // step

    def row(j):
        normals = [_unit(np.asarray(patches[(j, i)], np.float64))
                   for i in range(x + 1)]
        left = normals[0]
        for i, right in enumerate(normals[1:-1]):
            s1 = step * (i + 1)
            left = align_normal_x(left, right, s1, left.shape[2], 0,
                                  left.shape[2] - s1)
        left = align_normal_x(left, normals[-1], W - image_size,
                              left.shape[2], 0,
                              image_size - W + left.shape[2])
        return left

    rows = [row(j) for j in range(y + 1)]
    top = rows[0]
    for i, bottom in enumerate(rows[1:-1]):
        s1 = step * (i + 1)
        top = align_normal_y(top, bottom, s1, top.shape[1], 0,
                             top.shape[1] - s1)
    top = align_normal_y(top, rows[-1], H - image_size, top.shape[1], 0,
                         image_size - H + top.shape[1])

    # rotate the merged map onto the centre patch's frame (reference
    # :775-780: best-fit between the stitched middle crop and the direct
    # middle prediction)
    mid = _unit(np.asarray(patches["mid"], np.float64))
    y0 = H // 2 - image_size // 2
    x0 = W // 2 - image_size // 2
    mid_merged = top[:, y0:y0 + image_size, x0:x0 + image_size]
    R = best_fit_rotation(mid_merged.reshape(3, -1).T,
                          mid.reshape(3, -1).T)
    return _unit((R @ top.reshape(3, -1)).reshape(top.shape)) \
        .astype(np.float32)
