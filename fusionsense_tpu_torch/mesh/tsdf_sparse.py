"""Sparse (brick-hashed) TSDF fusion for room-scale scenes — host numpy.

A copy of fusionsense_tpu/mesh/tsdf_sparse.py (with its brick-seam fix:
every brick that receives a voxel, its own or in its apron, marches); the
bricks march through this package's marching tetrahedra, on the CPU.

The dense grid (mesh/tsdf.py) is the right shape for object scenes: the
whole 256^3 volume is one XLA program per view. At the reference's FIXED
0.004 m voxel (reference dn_splatter/export_mesh.py:803-817, vdbfusion
VDBVolume voxel 0.004 / trunc 0.012), a Replica/MuSHRoom/ScanNet++ room is
1000^3-2000^3 voxels — dense f32 tsdf+weight grids are 8-64 GB and OOM.

vdbfusion solves this with a C++ VDB tree updated along each ray. The
equivalent here keeps the same two ideas, vectorized in numpy:

1. **Band-limited ray updates**: per view, each valid pixel contributes
   only the voxels within +-truncation of its surface point along the ray
   (K = 2*ceil(trunc/voxel)+1 samples) — per-view work is O(H*W*K), not
   O(volume). Optional space carving visits the free-space segment at a
   configurable stride.
2. **A voxel hash** instead of a grid: int64-packed coordinates in sorted
   arrays; each view's (ids, tsdf) pairs are reduced with np.unique and
   merged into the global state with searchsorted — no python-loop data
   structure, no preallocated volume.

Extraction gathers each occupied 32^3 brick (plus a +1 apron) into a tiny
dense block and runs the same marching-tetrahedra as the dense path, so
sparse and dense meshes agree wherever both exist.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from fusionsense_tpu_torch.device import host

_BIAS = 1 << 20          # voxel coords in [-2^20, 2^20) — 8 km at 4 mm
_AXIS_BITS = 21


@dataclasses.dataclass(frozen=True)
class SparseTSDFConfig:
    voxel_size: float = 0.004        # reference export_mesh.py:803
    truncation: float = 0.012        # reference: 3 * voxel
    min_weight: float = 2.0
    brick: int = 32                  # extraction block edge (voxels)
    space_carving: bool = False      # also clear free space along rays
    carve_stride: int = 4            # free-space sampling stride (voxels)
    max_depth: float = 1e9           # ignore hits beyond this


def _pack(ijk: np.ndarray) -> np.ndarray:
    """(N, 3) int voxel coords -> int64 keys (unique, order-preserving)."""
    q = ijk.astype(np.int64) + _BIAS
    return (q[:, 0] << (2 * _AXIS_BITS)) | (q[:, 1] << _AXIS_BITS) | q[:, 2]


def _unpack(keys: np.ndarray) -> np.ndarray:
    mask = (1 << _AXIS_BITS) - 1
    x = (keys >> (2 * _AXIS_BITS)) & mask
    y = (keys >> _AXIS_BITS) & mask
    z = keys & mask
    return np.stack([x, y, z], -1).astype(np.int64) - _BIAS


class SparseTSDF:
    """Voxel-hash TSDF volume; integrate depth maps, extract a mesh."""

    def __init__(self, cfg: SparseTSDFConfig = SparseTSDFConfig()):
        self.cfg = cfg
        self.keys = np.empty((0,), np.int64)    # sorted voxel ids
        self.tsdf = np.empty((0,), np.float32)  # weighted-mean tsdf
        self.weight = np.empty((0,), np.float32)

    # ------------------------------------------------------ integration --
    def integrate(self, depth: np.ndarray, viewmat: np.ndarray,
                  fx: float, fy: float, cx: float, cy: float) -> None:
        """Fuse one z-depth map (H, W), 0/neg = invalid. viewmat is
        world->camera (4, 4), OpenCV convention (+z forward)."""
        cfg = self.cfg
        H, W = depth.shape
        d = np.asarray(depth, np.float32).reshape(-1)
        valid = (d > 1e-4) & (d < cfg.max_depth)
        if not valid.any():
            return
        d = d[valid]
        vs, us = np.nonzero(valid.reshape(H, W))
        # camera-space rays through pixel centers
        rx = (us.astype(np.float32) + 0.5 - cx) / fx
        ry = (vs.astype(np.float32) + 0.5 - cy) / fy
        rays = np.stack([rx, ry, np.ones_like(rx)], -1)       # (P, 3)
        R = np.asarray(viewmat[:3, :3], np.float32)
        t = np.asarray(viewmat[:3, 3], np.float32)
        origin = -R.T @ t
        rays_w = rays @ R                                      # (P, 3) world
        # z-depth parametrization: point(z) = origin + z * rays_w
        K = 2 * int(np.ceil(cfg.truncation / cfg.voxel_size)) + 1
        offs = (np.arange(K, dtype=np.float32) - K // 2) * cfg.voxel_size
        z = d[:, None] + offs[None, :]                         # (P, K)
        pts = origin + rays_w[:, None, :] * z[..., None]       # (P, K, 3)
        sdf = (d[:, None] - z)                                 # (P, K)
        keep = (z > 1e-4) & (sdf > -cfg.truncation)
        obs = np.clip(sdf / cfg.truncation, -1.0, 1.0)[keep]
        ijk = np.floor(pts[keep] / cfg.voxel_size).astype(np.int64)
        # guard the 21-bit axis fields: a garbage depth (unit mix-up,
        # corrupt pixel) would otherwise overflow into the neighbor axis
        # and alias legitimate voxels
        in_range = np.all(np.abs(ijk) < _BIAS, axis=1)
        ids = _pack(ijk[in_range])
        obs = obs[in_range]
        if cfg.space_carving:
            # free-space segment [near, d - trunc) at a coarse stride
            step = cfg.carve_stride * cfg.voxel_size
            n_carve = int(np.ceil((d.max() - cfg.truncation) / step))
            if n_carve > 0:
                zc = (np.arange(n_carve, dtype=np.float32) + 0.5) * step
                zc = np.broadcast_to(zc, (len(d), n_carve))
                keep_c = zc < (d[:, None] - cfg.truncation)
                pts_c = origin + rays_w[:, None, :] * zc[..., None]
                ijk_c = np.floor(
                    pts_c[keep_c] / cfg.voxel_size).astype(np.int64)
                ijk_c = ijk_c[np.all(np.abs(ijk_c) < _BIAS, axis=1)]
                ids_c = _pack(ijk_c)
                ids = np.concatenate([ids, ids_c])
                obs = np.concatenate(
                    [obs, np.ones(len(ids_c), np.float32)])
        self._merge(ids, obs)

    def _merge(self, ids: np.ndarray, obs: np.ndarray) -> None:
        # reduce this view's duplicates (a voxel hit by several rays)
        uids, inv = np.unique(ids, return_inverse=True)
        acc = np.zeros(len(uids), np.float32)
        cnt = np.zeros(len(uids), np.float32)
        np.add.at(acc, inv, obs)
        np.add.at(cnt, inv, 1.0)
        # split into existing vs new voxels
        pos = np.searchsorted(self.keys, uids)
        pos_c = np.minimum(pos, max(len(self.keys) - 1, 0))
        exists = (len(self.keys) > 0) & (self.keys[pos_c] == uids) \
            if len(self.keys) else np.zeros(len(uids), bool)
        e = np.nonzero(exists)[0]
        w_old = self.weight[pos[e]] if len(e) else np.empty(0, np.float32)
        self.tsdf[pos[e]] = (self.tsdf[pos[e]] * w_old + acc[e]) / (
            w_old + cnt[e])
        self.weight[pos[e]] += cnt[e]
        n = np.nonzero(~exists)[0]
        if len(n):
            # linear merge: both arrays are sorted, so np.insert at the
            # searchsorted positions is O(N) — a full argsort per view
            # would be hundreds of redundant 10^7-element sorts at room
            # scale
            at = pos[n]
            self.keys = np.insert(self.keys, at, uids[n])
            self.tsdf = np.insert(self.tsdf, at, acc[n] / cnt[n])
            self.weight = np.insert(self.weight, at, cnt[n])

    # ------------------------------------------------------- extraction --
    def extract_mesh(self):
        """Per-brick marching tetrahedra. Returns (verts (V, 3) world,
        faces (F, 3)).

        Voxels are grouped into bricks with ONE global sort of
        (brick_key, voxel) pairs — each voxel joins its own brick plus the
        aprons of up to 7 neighbors (boundary coords only) — instead of a
        per-brick scan of the whole hash (that form was quadratic: a
        room-scale volume has 10^4 bricks x 10^7 voxels)."""
        from fusionsense_tpu_torch.mesh.marching import marching_tetrahedra

        cfg = self.cfg
        Bk = cfg.brick
        occ = self.weight >= cfg.min_weight
        if not occ.any():
            return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
        ijk = _unpack(self.keys)[occ]
        tsdf = self.tsdf[occ]
        own = np.floor_divide(ijk, Bk)                      # (N, 3)
        # per-axis apron membership: voxel also feeds brick-1 when it is a
        # low-boundary coord (c % Bk == 0), brick+1 when high (== Bk - 1)
        rem = ijk - own * Bk
        ext = np.where(rem == 0, -1, np.where(rem == Bk - 1, 1, 0))  # (N,3)
        rows, bkeys = [], []
        idx = np.arange(len(ijk))
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    combo = np.array([cx, cy, cz])
                    off = ext * combo                       # (N, 3)
                    valid = np.all((combo == 0) | (ext != 0), axis=1)
                    if not valid.any():
                        continue
                    rows.append(idx[valid])
                    bkeys.append(_pack(own[valid] + off[valid]))
        rows = np.concatenate(rows)
        bkeys = np.concatenate(bkeys)
        order = np.argsort(bkeys, kind="stable")
        rows, bkeys = rows[order], bkeys[order]
        starts = np.concatenate(
            [[0], np.nonzero(np.diff(bkeys))[0] + 1, [len(bkeys)]])
        # every brick that RECEIVED a voxel (own or apron) marches: a
        # crossing cube can be owned by a brick whose only nearby occupied
        # voxel sits in its apron (band ending exactly at a brick
        # boundary) — filtering to owner bricks dropped those faces and
        # left 32-voxel-aligned seam holes (round-5 review finding)

        all_v, all_f, base = [], [], 0
        side = Bk + 2   # +1 apron each side closes surfaces across bricks
        for s, e in zip(starts[:-1], starts[1:]):
            bkey = bkeys[s]
            sel = rows[s:e]
            b0 = _unpack(np.asarray([bkey]))[0] * Bk          # brick origin
            lo = b0 - 1                                        # apron
            local = ijk[sel] - lo
            field = np.ones((side, side, side), np.float32)    # unobserved
            field[local[:, 0], local[:, 1], local[:, 2]] = tsdf[sel]
            verts, faces = marching_tetrahedra(
                field, iso=0.0,
                origin=(lo.astype(np.float64) + 0.5) * cfg.voxel_size,
                spacing=cfg.voxel_size)
            # drop faces whose cubes lie fully in the apron: those cubes
            # belong to (and are re-emitted by) the neighboring brick
            if len(faces):
                centers = verts[faces].mean(1)
                cell = centers / cfg.voxel_size - 0.5 - lo
                owned_faces = np.all((cell >= 0.0) & (cell < Bk), axis=1)
                faces = faces[owned_faces]
            if len(faces):
                used = np.unique(faces)
                remap = np.full(len(verts), -1, np.int64)
                remap[used] = np.arange(len(used))
                all_v.append(verts[used])
                all_f.append(remap[faces] + base)
                base += len(used)
        if not all_v:
            return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
        return np.concatenate(all_v), np.concatenate(all_f)


def fuse_depths_sparse(depths, cameras, cfg: SparseTSDFConfig) -> SparseTSDF:
    """Integrate all views (depths (V, H, W), batched Camera; tensors on any
    device or numpy arrays)."""
    vol = SparseTSDF(cfg)
    depths = host(depths)
    V = depths.shape[0]
    vm = host(cameras.viewmat)
    fx, fy = host(cameras.fx), host(cameras.fy)
    cx, cy = host(cameras.cx), host(cameras.cy)
    for i in range(V):
        vol.integrate(np.asarray(depths[i]), vm[i],
                      float(fx[i]), float(fy[i]),
                      float(cx[i]), float(cy[i]))
    return vol
