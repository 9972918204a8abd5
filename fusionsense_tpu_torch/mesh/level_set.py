"""Gaussian-density queries and the SuGaR-style level-set surface.

Counterpart of fusionsense_tpu/mesh/level_set.py (the reference's
dn_model.py:1445-1946 and export_mesh.py:487-681 `sugar-coarse`):
- density(p) = sum_i o_i * exp(-1/2 (p - mu_i)^T Sigma_i^-1 (p - mu_i)),
  over the K = 16 nearest Gaussians (the SDF loss uses it too),
- per camera: backproject the rendered depth, march 21 samples over
  +-3 sigma along each pixel ray, find the first crossing of the density
  level (or the density peak), interpolate the crossing point,
- normals: the analytic density gradient over one matrix norm of the whole
  (P, 3) array, as the JAX package computes it (jnp.linalg.norm(g, -1) takes
  -1 as `ord`: the smallest column sum of |g|; ROADMAP F5), so these are
  not unit vectors; or the closest Gaussian's normal,
- the density voxel grid of the `marching` mesh mode.
The KNN is a chunked matmul + topk and the density a batched quadratic
form, all on the device of the Gaussians.
"""
from __future__ import annotations

import torch

from fusionsense_tpu_torch.core.transforms import quat_scale_to_inv_cov3d


@torch.no_grad()
def knn_indices(points: torch.Tensor, refs: torch.Tensor,
                ref_valid: torch.Tensor, k: int = 16,
                chunk: int = 4096) -> torch.Tensor:
    """(P, 3) query points -> (P, k) indices of the nearest valid refs (N, 3).
    Indices carry no gradient."""
    ref_sq = torch.sum(refs * refs, -1)
    out = []
    for p in torch.split(points, chunk):
        d2 = (torch.sum(p * p, -1)[:, None] - 2.0 * (p @ refs.T)
              + ref_sq[None, :])
        d2 = torch.where(ref_valid[None, :], d2,
                         torch.full_like(d2, float("inf")))
        out.append(torch.topk(-d2, k, dim=-1).indices)
    return torch.cat(out, 0)


def density_at(points: torch.Tensor, knn_idx: torch.Tensor,
               means: torch.Tensor, icovs: torch.Tensor,
               opacities: torch.Tensor) -> torch.Tensor:
    """(P,) Gaussian-mixture density against each point's K nearest
    Gaussians (knn_idx (P, K))."""
    mu = means[knn_idx]                   # (P, K, 3)
    A = icovs[knn_idx]                    # (P, K, 3, 3)
    o = opacities[knn_idx]                # (P, K)
    d = points[:, None, :] - mu
    q = torch.einsum("pki,pkij,pkj->pk", d, A, d)
    return torch.sum(o * torch.exp(-0.5 * q), dim=-1)


def density_gradient(points, knn_idx, means, icovs, opacities):
    """Analytic gradient of the mixture density: (P, 3)."""
    mu = means[knn_idx]
    A = icovs[knn_idx]
    o = opacities[knn_idx]
    d = points[:, None, :] - mu
    Ad = torch.einsum("pkij,pkj->pki", A, d)
    q = torch.einsum("pki,pki->pk", d, Ad)
    w = o * torch.exp(-0.5 * q)
    return -torch.sum(w[..., None] * Ad, dim=1)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """float32 linspace by jnp.linspace's rule: start * (1 - s) + stop * s
    at s = i / (num - 1), the last point exactly stop."""
    div = num - 1
    s = torch.arange(div, dtype=torch.float32, device=device) / div
    head = start * (1 - s) + stop * s
    return torch.cat([head, torch.full((1,), stop, device=device)])


def _gradient_normals(g: torch.Tensor) -> torch.Tensor:
    """-g over max(matrix norm, 1e-12) with ord -1, the smallest column sum
    of |g|: the reference's jnp.linalg.norm(g, -1, keepdims=True)."""
    return -g / torch.clamp_min(
        torch.linalg.matrix_norm(g, ord=-1, keepdim=True), 1e-12)


@torch.no_grad()
def level_surface_from_depth(
    depth: torch.Tensor,          # (H, W) rendered z-depth
    viewmat: torch.Tensor, fx, fy, cx, cy,
    means: torch.Tensor, quats: torch.Tensor, scales: torch.Tensor,
    opacities: torch.Tensor, alive: torch.Tensor,
    gauss_normals: torch.Tensor,  # (N, 3) per-Gaussian normals
    *,
    width: int, height: int,
    level: float = 0.3,
    sigma_range: float = 3.0,
    n_samples: int = 21,
    k: int = 16,
    chunk: int = 4096,
    normal_mode: str = "closest_gaussian",  # | "analytical"
    level_mode: str = "absolute",  # | "relative" | "peak"
):
    """One camera's level-set samples, on the device of the inputs.

    level_mode: "absolute", the crossing of `level` (the reference's
    sugar-coarse semantics); "relative", the crossing of `level` x the
    ray's largest density; "peak", the parabolic refinement of the density
    maximum along the ray, `level` only gating validity.

    Returns (points (H*W, 3), normals (H*W, 3), valid (H*W,))."""
    H, W = depth.shape
    dev = depth.device
    c2w_R = torch.linalg.inv(viewmat)[:3, :3]
    origin = -viewmat[:3, :3].T @ viewmat[:3, 3]

    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    dirs_cam = torch.stack([(gx - cx) / fx, (gy - cy) / fy,
                            torch.ones_like(gx)], -1)
    dirs = dirs_cam.reshape(-1, 3) @ c2w_R.T
    z = depth.reshape(-1)
    valid = z > 1e-4
    surf = origin + dirs * z[:, None]      # backprojected surface estimate

    icovs = quat_scale_to_inv_cov3d(quats, scales)
    op = torch.where(alive, opacities, torch.zeros_like(opacities))

    idx = knn_indices(surf, means, alive, k=k, chunk=chunk)

    # local sigma: mean scale of the K nearest Gaussians
    sigma = torch.mean(torch.mean(scales[idx], dim=-1), dim=-1)   # (P,)
    ts = _linspace(-sigma_range, sigma_range, n_samples, dev)

    dens = torch.stack([
        density_at(surf + dirs * (sigma * t)[:, None], idx, means, icovs, op)
        for t in ts])                              # (S, P)  near -> far

    if level_mode == "peak":
        S = n_samples
        i0 = torch.clamp(torch.argmax(dens, dim=0), 1, S - 2)
        dm = torch.gather(dens, 0, (i0 - 1)[None])[0]
        dc = torch.gather(dens, 0, i0[None])[0]
        dp = torch.gather(dens, 0, (i0 + 1)[None])[0]
        denom = dm - 2.0 * dc + dp
        off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (dm - dp) / denom,
                          torch.zeros_like(denom))
        t_star = ts[i0] + torch.clamp(off, -1.0, 1.0) * (ts[1] - ts[0])
        pts = surf + dirs * (sigma * t_star)[:, None]
        valid = valid & (torch.amax(dens, dim=0) >= level)
    else:
        # first crossing of the level between consecutive samples
        lvl = (level * torch.amax(dens, dim=0) if level_mode == "relative"
               else torch.full((dens.shape[1],), level, dtype=dens.dtype,
                               device=dev))
        above = dens >= lvl[None]
        cross = (~above[:-1]) & above[1:] | (above[:-1] & ~above[1:])
        any_cross = torch.any(cross, dim=0)
        # argmax of a bool: cast first (no CUDA argmax for bool); both
        # return the first maximum
        first = torch.argmax(cross.to(torch.uint8), dim=0)
        d0 = torch.gather(dens, 0, first[None])[0]
        d1 = torch.gather(dens, 0, (first + 1)[None])[0]
        t0 = ts[first]
        t1 = ts[first + 1]
        dd = d1 - d0
        frac = torch.clamp((lvl - d0) / torch.where(
            torch.abs(dd) < 1e-12, torch.full_like(dd, 1e-12), dd), 0.0, 1.0)
        t_star = t0 + frac * (t1 - t0)
        pts = surf + dirs * (sigma * t_star)[:, None]
        valid = valid & any_cross

    if normal_mode == "analytical":
        normals = _gradient_normals(density_gradient(pts, idx, means, icovs,
                                                     op))
    else:
        normals = gauss_normals[idx[:, 0]]
    return pts, normals, valid


@torch.no_grad()
def density_grid(means, quats, scales, opacities, alive, *, origin,
                 voxel_size: float, resolution: tuple, k: int = 16,
                 chunk: int = 4096) -> torch.Tensor:
    """Gaussian-density voxel grid of the `marching` mesh mode (the
    reference's export_mesh.py:683-786, iso 0.5), shaped `resolution`, on
    the device of the Gaussians; the K nearest Gaussians of each voxel
    center are found and evaluated one chunk at a time."""
    dev = means.device
    axes = []
    for n, o in zip(resolution, origin):
        a = torch.arange(n, dtype=torch.float32, device=dev)
        axes.append(a * voxel_size + float(o) + voxel_size / 2)
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    icovs = quat_scale_to_inv_cov3d(quats, scales)
    op = torch.where(alive, opacities, torch.zeros_like(opacities))
    dens = torch.cat([
        density_at(p, knn_indices(p, means, alive, k=k, chunk=chunk), means,
                   icovs, op)
        for p in torch.split(pts, chunk)])
    return dens.reshape(resolution)
