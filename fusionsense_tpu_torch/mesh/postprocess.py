"""Mesh/depth post-processing: smoothing, decimation, edge filtering.

A copy of fusionsense_tpu/mesh/postprocess.py (host numpy there and here:
each runs once per mesh on arrays already on the host). Reference parity
items around mesh extraction (reference dn_splatter/export_mesh.py):
- Laplacian mesh smoothing (the `smoothed_1/2_...` Poisson variants,
  export_mesh.py:668-676),
- quadric-style simplification (the optional decimation of the TSDF mesh,
  :915) — implemented as vertex-clustering decimation (grid collapse),
  which preserves topology well enough for touch planning at a fraction
  of the code,
- depth-edge (Laplacian) filtering of rendered depth maps before
  backprojection (`find_depth_edges`, :59-91) used by the `dn` method.
"""
from __future__ import annotations

import numpy as np


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray,
                     iterations: int = 1, lam: float = 0.5) -> np.ndarray:
    """Uniform-weight Laplacian smoothing."""
    n = len(verts)
    src = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2],
                          faces[:, 1], faces[:, 2], faces[:, 0]])
    dst = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0],
                          faces[:, 0], faces[:, 1], faces[:, 2]])
    deg = np.zeros(n)
    np.add.at(deg, src, 1.0)
    deg = np.maximum(deg, 1.0)
    out = verts.astype(np.float64).copy()
    for _ in range(iterations):
        acc = np.zeros_like(out)
        np.add.at(acc, src, out[dst])
        out = out + lam * (acc / deg[:, None] - out)
    return out.astype(np.float32)


def decimate_vertex_clustering(verts: np.ndarray, faces: np.ndarray,
                               voxel: float):
    """Collapse vertices sharing a voxel cell; drop degenerate faces."""
    key = np.floor(verts / voxel).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # new vertex = mean of cluster members
    new_verts = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq))
    np.add.at(new_verts, inv, verts)
    np.add.at(counts, inv, 1.0)
    new_verts /= counts[:, None]
    new_faces = inv[faces]
    ok = ((new_faces[:, 0] != new_faces[:, 1])
          & (new_faces[:, 1] != new_faces[:, 2])
          & (new_faces[:, 0] != new_faces[:, 2]))
    return new_verts.astype(np.float32), new_faces[ok]


def find_depth_edges(depth: np.ndarray, threshold: float = 0.01,
                     dilate: int = 1) -> np.ndarray:
    """Boolean mask of depth discontinuities (Laplacian magnitude above
    threshold x depth), optionally dilated — pixels to EXCLUDE before
    backprojection (reference find_depth_edges, export_mesh.py:59-91)."""
    lap = np.zeros_like(depth)
    lap[1:-1, 1:-1] = (
        4 * depth[1:-1, 1:-1] - depth[:-2, 1:-1] - depth[2:, 1:-1]
        - depth[1:-1, :-2] - depth[1:-1, 2:])
    edges = np.abs(lap) > threshold * np.maximum(depth, 1e-6)
    for _ in range(dilate):
        e = edges.copy()
        e[1:, :] |= edges[:-1, :]
        e[:-1, :] |= edges[1:, :]
        e[:, 1:] |= edges[:, :-1]
        e[:, :-1] |= edges[:, 1:]
        edges = e
    return edges
