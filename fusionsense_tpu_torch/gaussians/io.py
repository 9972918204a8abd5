"""Gaussian-splat import/export in the standard 3DGS PLY layout.

Counterpart of fusionsense_tpu/gaussians/io.py: the INRIA-convention vertex
properties (x y z, nx ny nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*), so
a trained model opens in any standard splat viewer.
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.gaussians.store import GaussianState, new_state
from fusionsense_tpu_torch.utils.ply import read_ply, write_ply


def export_splat_ply(path, state: GaussianState, untransform=None) -> int:
    """Write the alive Gaussians in the standard 3DGS PLY layout; returns
    their count. `untransform` maps (n, 3) numpy means to the output frame."""
    host = {k: v.detach().cpu().numpy() for k, v in state.fields().items()}
    alive = host["alive"]
    means = host["means"][alive]
    if untransform is not None:
        means = untransform(means)
    n = len(means)

    f_dc = host["features_dc"][alive]                     # (n, 3)
    # the standard layout stores the rest coefficients channel-major:
    # f_rest_[c*(K-1)+k] = coeff[k, c]
    f_rest_flat = host["features_rest"][alive].transpose(0, 2, 1).reshape(n, -1)
    extra = {f"f_dc_{j}": f_dc[:, j] for j in range(3)}
    for j in range(f_rest_flat.shape[1]):
        extra[f"f_rest_{j}"] = f_rest_flat[:, j]
    extra["opacity"] = host["logit_opacities"][alive]
    log_scales = host["log_scales"][alive]
    for j in range(3):
        extra[f"scale_{j}"] = log_scales[:, j]
    quats = host["quats"][alive]
    quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True),
                               1e-12)
    for j in range(4):
        extra[f"rot_{j}"] = quats[:, j]

    write_ply(path, means, normals=np.zeros((n, 3), np.float32), extra=extra)
    return n


def import_splat_ply(path, capacity: int | None = None,
                     device=None) -> GaussianState:
    """Load a standard 3DGS PLY into a GaussianState on `device` (the card
    unless given)."""
    d = read_ply(path)
    pts = d["points"]
    n = len(pts)
    rest_keys = sorted((k for k in d if k.startswith("f_rest_")),
                       key=lambda k: int(k.split("_")[-1]))
    n_rest = len(rest_keys) // 3
    deg = int(round(np.sqrt(n_rest + 1))) - 1
    cap = capacity or max(1024, 1 << (n - 1).bit_length())
    state = new_state(cap, sh_degree=deg, device=device)

    f_dc = np.stack([d[f"f_dc_{j}"] for j in range(3)], -1)
    if rest_keys:
        flat = np.stack([d[k] for k in rest_keys], -1)      # (n, 3*(K-1))
        f_rest = flat.reshape(n, 3, n_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    quats = np.stack([d[f"rot_{j}"] for j in range(4)], -1)
    log_scales = np.stack([d[f"scale_{j}"] for j in range(3)], -1)

    def put(arr, v):
        out = arr.clone()
        out[:n] = torch.as_tensor(np.ascontiguousarray(v), dtype=arr.dtype)
        return out

    alive = state.alive.clone()
    alive[:n] = True
    return state.replace(
        means=put(state.means, pts), quats=put(state.quats, quats),
        log_scales=put(state.log_scales, log_scales),
        logit_opacities=put(state.logit_opacities, d["opacity"]),
        features_dc=put(state.features_dc, f_dc),
        features_rest=put(state.features_rest, f_rest), alive=alive)
