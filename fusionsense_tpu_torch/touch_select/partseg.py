"""Zero-shot 3D part segmentation: render -> detect -> superpoints -> vote.

Counterpart of fusionsense_tpu/touch_select/partseg.py (the PartSlip
pipeline, reference PartSlip/src/: normalize_pc, render_pc's 10 fixed
viewpoints with per-pixel point indices, glip_inference's per-view boxes,
gen_superpoint's normals + KNN graph + cut-pursuit, bbox2seg's vote — a
superpoint belongs to a part if >= 50% of its visible pixels fall in that
part's boxes).

The z-buffer runs as torch on the device. JAX writes far-to-near with a
duplicate-index scatter, which on its CPU makes the nearest point win and
the lowest index win at equal depth; the port computes that map
deterministically on any device: the least depth per pixel by an amin
scatter, then the least index among the points at that depth. The
projection is the JAX CPU dot's own arithmetic (a float32 FMA chain over
the three coordinates), made exact in float64, so the card and the CPU
give JAX's map. Normals and the KNN graph run on the host with scipy's
cKDTree in place of scikit-learn's NearestNeighbors (the same k, the
same neighbours where distances are distinct), the partition with the
port's cut-pursuit (native.py), which raises rather than falling back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Protocol

import numpy as np
import torch

from fusionsense_tpu_torch.data.synthetic import look_at_w2c


# ------------------------------------------------------------ normalize ----

def normalize_pc(points: np.ndarray):
    """Center + scale to unit norm (reference utils.py:5-15).
    Returns (normalized, center, scale)."""
    center = points.mean(axis=0)
    x = points - center
    scale = np.abs(x).max()
    return x / max(scale, 1e-12), center, float(scale)


# --------------------------------------------------------- point render ----

def fixed_viewpoints(n: int = 10, radius: float = 2.2, elevations=(0.35, -0.35)):
    """n cameras on two elevation rings around the normalized cloud."""
    mats = []
    per_ring = (n + 1) // 2
    for e_i, elev in enumerate(elevations):
        for i in range(per_ring):
            if len(mats) >= n:
                break
            a = 2 * math.pi * (i + 0.5 * e_i) / per_ring
            eye = np.array([radius * math.cos(a), radius * math.sin(a),
                            radius * math.sin(elev)])
            mats.append(look_at_w2c(eye, np.zeros(3)))
    return np.stack(mats)


def _fma_chain(p: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """float32 sum_k p[:, k] * row[k], each step one fused multiply-add
    (k = 0, 1, 2), as XLA's CPU dot forms it; the product of two float32
    is exact in float64 and the sum is rounded once to float32."""
    acc = p[:, 0] * row[0]
    for k in (1, 2):
        acc = (p[:, k].double() * row[k].double() + acc.double()).float()
    return acc


def _zbuffer_render(points, colors, viewmat, focal, *, size: int):
    """Splat points with a z-buffer; returns (rgb, idx_map, depth).

    idx_map[y, x] = index of the nearest point covering the pixel (-1 none;
    the lowest index among points at equal depth). Single-pixel splats at
    `size` resolution. Tensors on one device; float32 points and viewmat.
    """
    n = points.shape[0]
    dev = points.device
    p = torch.stack([_fma_chain(points, viewmat[j, :3]) + viewmat[j, 3]
                     for j in range(3)], dim=1)
    z = p[:, 2]
    valid = z > 1e-4
    zs = torch.where(valid, z, 1e9)
    u = p[:, 0] / zs * focal + size / 2
    v = p[:, 1] / zs * focal + size / 2
    ui = torch.clamp(u.to(torch.int32), 0, size - 1)
    vi = torch.clamp(v.to(torch.int32), 0, size - 1)
    onscreen = valid & (u >= 0) & (u < size) & (v >= 0) & (v < size)
    pix = torch.where(onscreen, vi * size + ui, size * size).to(torch.int64)

    zbuf = torch.full((size * size + 1,), 1e9, device=dev).scatter_reduce(
        0, pix, zs, "amin")
    nearest = zs == zbuf[pix]
    ids = torch.arange(n, device=dev)
    first = torch.full((size * size + 1,), n, device=dev).scatter_reduce(
        0, pix[nearest], ids[nearest], "amin")
    idx = torch.where(first < n, first, -1).to(torch.int32)[:-1]
    rgb = torch.where((idx >= 0)[:, None],
                      colors[torch.clamp_min(idx, 0).to(torch.int64)], 1.0)
    return (rgb.reshape(size, size, 3), idx.reshape(size, size),
            zbuf[:-1].reshape(size, size))


def render_views(points: np.ndarray, colors: np.ndarray, n_views: int = 10,
                 size: int = 800, focal_ratio: float = 0.9, device=None):
    """Render the normalized cloud from fixed viewpoints on `device` (the
    card unless "cpu" is asked for).

    Returns list of dicts {rgb, idx, depth, viewmat} (host numpy).
    """
    from fusionsense_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    mats = fixed_viewpoints(n_views)
    focal = focal_ratio * size / 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    out = []
    for m in mats:
        rgb, idx, depth = _zbuffer_render(
            pts, cols, torch.as_tensor(m.astype(np.float32), device=dev),
            focal, size=size)
        out.append({"rgb": rgb.cpu().numpy(), "idx": idx.cpu().numpy(),
                    "depth": depth.cpu().numpy(), "viewmat": m,
                    "focal": focal})
    return out


# ----------------------------------------------------------- detector ------

@dataclasses.dataclass
class Detection:
    boxes: np.ndarray      # (B, 4) x0, y0, x1, y1 pixels
    labels: list[int]      # part index per box
    scores: np.ndarray     # (B,)


class Detector(Protocol):
    """Open-vocabulary text-grounded detector (the GLIP slot)."""

    def detect(self, rgb: np.ndarray, part_names: list[str]) -> Detection: ...


# -------------------------------------------------------- superpoints ------

def _knn(points: np.ndarray, k: int) -> np.ndarray:
    """(N, k) indices of each point's k nearest points, the point itself
    first, nearest first (scikit-learn's kneighbors on the fitted points,
    for clouds without duplicate points)."""
    from scipy.spatial import cKDTree

    _, idx = cKDTree(points).query(points, k=k)
    return idx.reshape(len(points), k)


def estimate_normals(points: np.ndarray, k: int = 10) -> np.ndarray:
    """PCA normals from the k-NN neighborhood (host scipy)."""
    nbrs = points[_knn(points, k)]          # (N, k, 3)
    x = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", x, x)
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, :, 0]                    # smallest-eigenvalue direction


def superpoints(points: np.ndarray, k: int = 10, reg: float = 0.05,
                min_size: int = 10) -> np.ndarray:
    """Partition the cloud into geometrically-coherent superpoints: the
    native L0 cut-pursuit solver on (xyz + 0.5 normal) features over the
    k-NN graph (the reference's libcp.cutpursuit,
    PartSlip/partition/cut-pursuit), small components merged into their
    neighbours. Returns (N,) labels."""
    from fusionsense_tpu_torch.native import cutpursuit

    normals = estimate_normals(points, k)
    feats = np.concatenate([points, 0.5 * normals], axis=1)
    idx = _knn(points, k + 1)
    src = np.repeat(np.arange(len(points)), k)
    dst = idx[:, 1:].reshape(-1)
    w = np.ones(len(src), np.float32)
    labels = cutpursuit(feats.astype(np.float32), src, dst, edge_w=w, reg=reg)
    labels = _merge_small(labels, idx[:, 1:], min_size)
    # compact label ids
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def _region_grow(points, normals, nbr_idx, angle_thresh=0.90):
    """Greedy BFS region growing with normal-coherence gating."""
    n = len(points)
    labels = np.full(n, -1, np.int64)
    cur = 0
    for seed in range(n):
        if labels[seed] >= 0:
            continue
        stack = [seed]
        labels[seed] = cur
        while stack:
            i = stack.pop()
            for j in nbr_idx[i]:
                if labels[j] >= 0:
                    continue
                if abs(float(normals[i] @ normals[j])) >= angle_thresh:
                    labels[j] = cur
                    stack.append(j)
        cur += 1
    return labels


def _merge_small(labels, nbr_idx, min_size):
    """Merge components smaller than min_size into their dominant neighbor
    (reference gen_superpoint.py merges < 10-point components)."""
    labels = labels.copy()
    for _ in range(3):
        ids, counts = np.unique(labels, return_counts=True)
        small = set(ids[counts < min_size].tolist())
        if not small:
            break
        for i in np.nonzero(np.isin(labels, list(small)))[0]:
            nbr_labels = labels[nbr_idx[i]]
            ok = nbr_labels[~np.isin(nbr_labels, list(small))]
            if len(ok):
                labels[i] = np.bincount(ok).argmax()
    return labels


# ------------------------------------------------------------- voting ------

def bbox_vote(
    views: list[dict],                 # from render_views
    detections: list[Detection],       # one per view
    sp_labels: np.ndarray,             # (N,) superpoint label per point
    n_parts: int,
    sem_threshold: float = 0.5,
) -> np.ndarray:
    """Superpoint voting: per-part visible-inside-box fraction >= threshold
    (reference bbox2seg.py:36-175). Returns (N,) part index, -1 unassigned."""
    n_sp = int(sp_labels.max()) + 1 if len(sp_labels) else 0
    in_box = np.zeros((n_sp, n_parts), np.float64)
    visible = np.zeros((n_sp,), np.float64)

    for view, det in zip(views, detections):
        idx_map = view["idx"]
        vis_pts = idx_map[idx_map >= 0]
        ys, xs = np.nonzero(idx_map >= 0)
        sp_of_pix = sp_labels[vis_pts]
        np.add.at(visible, sp_of_pix, 1.0)
        for b in range(len(det.labels)):
            x0, y0, x1, y1 = det.boxes[b]
            inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
            np.add.at(in_box[:, det.labels[b]], sp_of_pix[inside], 1.0)

    frac = in_box / np.maximum(visible[:, None], 1.0)
    best = frac.argmax(axis=1)
    assigned = frac.max(axis=1) >= sem_threshold
    sp_part = np.where(assigned, best, -1)
    return sp_part[sp_labels]


def segment_parts(
    points: np.ndarray,
    colors: np.ndarray,
    part_names: list[str],
    detector: Detector,
    n_views: int = 10,
    render_size: int = 800,
    sp_k: int = 10,
    device=None,
) -> np.ndarray:
    """Full pipeline: returns (N,) part index per point (-1 unassigned).
    The renders run on `device` (the card unless "cpu" is asked for)."""
    from fusionsense_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    norm_pts, center, scale = normalize_pc(points)
    views = render_views(norm_pts, colors, n_views=n_views, size=render_size,
                         device=dev)
    detections = [detector.detect(v["rgb"], part_names) for v in views]
    sp = superpoints(norm_pts, k=sp_k)
    return bbox_vote(views, detections, sp, n_parts=len(part_names))
