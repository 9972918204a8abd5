"""Iso-surface extraction: vectorised marching tetrahedra on the device.

Counterpart of fusionsense_tpu/mesh/marching.py (host numpy there). The
field's cube corners, the per-tetrahedron cases, the edge interpolation,
the orientation test and the weld run as float64 torch ops on the device
that holds the field, so a 192^3 grid (about 450 MB of corner values) is
the card's work. The output is the numpy version's exactly: the same Kuhn
tetrahedra, the same case table in the same insertion order, so the same
triangle order and the same welded vertex order.

Convention: "inside" is value < iso (SDF-style). Output normals point
outward (toward increasing field value).
"""
from __future__ import annotations

import numpy as np
import torch

# Kuhn 6-tetrahedron decomposition of a cube around the body diagonal 0-7:
# one tet per axis-order permutation (0 -> a -> a|b -> 7). Face diagonals of
# adjacent cubes match (both use the low-to-high corner), so the global
# triangulation is conforming and the extracted surface watertight.
# Cube corner numbering: bit0 = +x, bit1 = +y, bit2 = +z.
_TETS = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
         (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]

# per-case triangles; each triangle is 3 edges; each edge (inside, outside)
_CASE_TRIS: dict[int, list] = {
    0b0001: [((0, 1), (0, 2), (0, 3))],
    0b0010: [((1, 0), (1, 3), (1, 2))],
    0b0100: [((2, 0), (2, 1), (2, 3))],
    0b1000: [((3, 0), (3, 2), (3, 1))],
    0b0011: [((0, 2), (0, 3), (1, 2)), ((1, 2), (0, 3), (1, 3))],
    0b0101: [((0, 1), (2, 1), (0, 3)), ((2, 1), (2, 3), (0, 3))],
    0b1001: [((0, 1), (0, 2), (3, 1)), ((3, 1), (0, 2), (3, 2))],
    0b0110: [((1, 0), (1, 3), (2, 0)), ((2, 0), (1, 3), (2, 3))],
    0b1010: [((1, 0), (3, 0), (1, 2)), ((1, 2), (3, 0), (3, 2))],
    0b1100: [((2, 0), (2, 1), (3, 0)), ((3, 0), (2, 1), (3, 1))],
}
for _c in list(_CASE_TRIS):
    _comp = (~_c) & 0b1111
    if _comp not in _CASE_TRIS:
        _CASE_TRIS[_comp] = [
            tuple((b, a) for (a, b) in tri) for tri in _CASE_TRIS[_c]
        ]

_CORNER_OFF = [(b & 1, (b >> 1) & 1, (b >> 2) & 1) for b in range(8)]


def _as_field(values) -> torch.Tensor:
    """A float64 tensor of the field, on the device that holds it (the CPU
    for a numpy array)."""
    if torch.is_tensor(values):
        return values.to(torch.float64)
    return torch.as_tensor(np.asarray(values, np.float64))


def _gradient_at(values: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """np.gradient(values) (unit spacing, edge_order 1) at the grid points
    ci (T, 3): central differences inside, one-sided at the faces, computed
    only where the orientation test reads them."""
    dims = values.shape
    g = []
    for axis in range(3):
        i = ci[:, axis]
        lo = torch.clamp(i - 1, min=0)
        hi = torch.clamp(i + 1, max=dims[axis] - 1)
        a, b = ci.clone(), ci.clone()
        a[:, axis], b[:, axis] = hi, lo
        diff = (values[a[:, 0], a[:, 1], a[:, 2]]
                - values[b[:, 0], b[:, 1], b[:, 2]])
        g.append(diff / (hi - lo).to(torch.float64))
    return torch.stack(g, -1)


def marching_tetrahedra(values, iso: float = 0.0, origin=(0.0, 0.0, 0.0),
                        spacing=1.0, weld: bool = True):
    """Extract the iso-surface of `values` (X, Y, Z), a tensor (on its own
    device) or a numpy array (on the CPU). Returns numpy (vertices (V, 3)
    float32, faces (F, 3) int64)."""
    values = _as_field(values)
    dev = values.device
    X, Y, Z = values.shape
    f64 = dict(dtype=torch.float64, device=dev)
    spacing = torch.as_tensor(np.broadcast_to(
        np.asarray(spacing, np.float64), (3,)).copy(), **f64)
    origin = torch.as_tensor(np.asarray(origin, np.float64), **f64)
    corner_off = torch.tensor(_CORNER_OFF, **f64)

    # cube corner values (X-1, Y-1, Z-1, 8) and cube base coordinates
    v = torch.stack([values[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
                     for dx, dy, dz in _CORNER_OFF], -1).reshape(-1, 8)
    # cheap prefilter: only cubes straddling the iso level
    straddle = torch.nonzero((v.amin(1) < iso) & (v.amax(1) >= iso))[:, 0]
    v = v[straddle]
    yz = (Y - 1) * (Z - 1)
    base = torch.stack([straddle // yz, (straddle // (Z - 1)) % (Y - 1),
                        straddle % (Z - 1)], -1).to(torch.float64)

    tris = []
    for tet in _TETS:
        tv = v[:, list(tet)]                           # (M, 4)
        inside = (tv < iso).to(torch.int32)
        case = (inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
                + 8 * inside[:, 3])
        for c, case_tris in _CASE_TRIS.items():
            m = case == c
            if not bool(m.any()):
                continue
            vb = base[m]
            vv = tv[m]
            for tri in case_tris:
                pts3 = []
                for (a, b) in tri:
                    va, vbv = vv[:, a], vv[:, b]
                    d = vbv - va
                    t = (iso - va) / torch.where(
                        torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
                    t = torch.clamp(t, 0.0, 1.0)
                    pa = vb + corner_off[tet[a]]
                    pb = vb + corner_off[tet[b]]
                    pts3.append(pa + t[:, None] * (pb - pa))
                tris.append(torch.stack(pts3, 1))      # (m, 3, 3)

    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_pts = torch.cat(tris, 0)                       # (T, 3, 3) grid coords

    # orientation: normal should align with +field gradient at the centroid
    p0, p1, p2 = tri_pts[:, 0], tri_pts[:, 1], tri_pts[:, 2]
    cent = (p0 + p1 + p2) / 3.0
    hi = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)
    ci = torch.minimum(torch.clamp(torch.round(cent).to(torch.int64), min=0),
                       hi)
    g = _gradient_at(values, ci)
    e1, e2 = p1 - p0, p2 - p0
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    ng = n * g
    flip = (ng[:, 0] + ng[:, 1] + ng[:, 2]) < 0
    tri_pts = torch.where(flip[:, None, None], tri_pts.flip(1), tri_pts)

    verts = tri_pts.reshape(-1, 3)
    faces = torch.arange(verts.shape[0], device=dev).reshape(-1, 3)
    if weld:
        key = torch.round(verts / 1e-6).to(torch.int64)
        _, inv = torch.unique(key, dim=0, return_inverse=True)
        # np.unique's return_index: the first occurrence of each key
        n_keys = int(inv.max()) + 1
        first = torch.full((n_keys,), verts.shape[0], dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, inv, torch.arange(verts.shape[0], device=dev), "amin")
        verts = verts[first]
        faces = inv[faces]
        # drop degenerate faces created by welding
        ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
        faces = faces[ok]

    verts = origin + verts * spacing
    return (verts.to(torch.float32).cpu().numpy(),
            faces.cpu().numpy().astype(np.int64))


def vertex_normals(verts, faces) -> np.ndarray:
    """Area-weighted vertex normals (V, 3), accumulated face by face in
    order with index_add_."""
    v = torch.as_tensor(np.asarray(verts))
    f = torch.as_tensor(np.asarray(faces, np.int64))
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], -1)
    out = torch.zeros_like(v)
    for i in range(3):
        out.index_add_(0, f[:, i], n)
    norm = torch.linalg.norm(out, dim=-1, keepdim=True)
    return (out / torch.clamp_min(norm, 1e-12)).numpy()
