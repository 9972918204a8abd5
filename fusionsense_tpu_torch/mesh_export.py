"""Mesh extraction front-end: the reference's `gs-mesh` methods.

Counterpart of fusionsense_tpu/mesh_export.py (reference
dn_splatter/export_mesh.py:926-943):
- "tsdf":         render depth per train camera -> TSDF fusion -> marching
                  tetrahedra                     (reference :788-925)
- "dn":           backproject rendered depth + normal maps -> oriented
                  cloud -> FFT Poisson           (reference :303-485)
- "sugar-coarse": per-camera level-set samples at a density level ->
                  FFT Poisson                    (reference :487-681)
- "gaussians":    means + normals (hull-pruned) -> FFT Poisson
                                                 (reference :105-299)
- "marching":     Gaussian-density voxel grid -> marching tetrahedra at
                  iso 0.5                        (reference :683-786)

Everything runs on the device of the Gaussians: the depth renders through
eval/evaluator.make_render_fn (K1 forward with backend="flat", K3 with
"pallas"), the fusion, the level set, the density grid, the Poisson solve
and the marching. The KD-tree trims, the depth-edge mask of "dn", the
smoothing and the PLY files are host numpy. All meshes are un-transformed
back to capture coordinates before saving.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera, backproject_depth
from fusionsense_tpu_torch.core.transforms import apply_se3_delta
from fusionsense_tpu_torch.device import host
from fusionsense_tpu_torch.eval.evaluator import make_render_fn
from fusionsense_tpu_torch.gaussians.store import GaussianState, activated
from fusionsense_tpu_torch.mesh.marching import (
    marching_tetrahedra, vertex_normals,
)
from fusionsense_tpu_torch.mesh.poisson import (
    PoissonConfig, poisson_reconstruct,
)
from fusionsense_tpu_torch.mesh.tsdf import (
    TSDFConfig, extract_mesh as tsdf_extract, fuse_depths,
)
from fusionsense_tpu_torch.render.rasterize import (
    RasterizeConfig, gaussian_flat_normals,
)
from fusionsense_tpu_torch.utils.ply import write_ply

METHODS = ("tsdf", "dn", "sugar-coarse", "gaussians", "marching")
# the methods that render the views' depths (_render_depths) first
RENDERING = ("tsdf", "dn", "sugar-coarse")


def _render_depths(gaussians, camera: Camera, rcfg, n_views: int):
    """(depths, normals, alphas) of the first n_views views, on the device;
    the depth gated to confidently covered pixels (alpha > 0.5) so faint
    floaters do not vote in the fusion."""
    render = make_render_fn(rcfg, camera)
    depths, normals, alphas = [], [], []
    for i in range(n_views):
        out = render(gaussians, i)
        depths.append(torch.where(out.alpha > 0.5, out.depth,
                                  torch.zeros_like(out.depth)))
        normals.append(out.normal)
        alphas.append(out.alpha)
    return torch.stack(depths), torch.stack(normals), torch.stack(alphas)


def _auto_tsdf_cfg(points: np.ndarray, resolution: int) -> TSDFConfig:
    lo, hi = points.min(0), points.max(0)
    extent = float((hi - lo).max()) * 1.2
    voxel = extent / resolution
    center = (lo + hi) / 2
    origin = tuple(center - extent / 2)
    return TSDFConfig(voxel_size=voxel, truncation=3 * voxel,
                      min_weight=2.0, origin=origin,
                      resolution=(resolution,) * 3)


def extract(
    method: str,
    gaussians: GaussianState,
    camera: Camera,                 # batched train cameras
    rasterize_cfg: RasterizeConfig,
    out_dir,
    untransform=None,
    hull_points: np.ndarray | None = None,
    resolution: int = 192,
    level: float = 0.3,
    level_mode: str = "absolute",
    poisson: PoissonConfig = PoissonConfig(),
    n_views: int | None = None,
    cam_deltas=None,
    voxel_size: float | None = None,
):
    """Extract a mesh with `method`, write mesh_<method>[_level_<level>].ply
    (and the smoothed variants of the Poisson methods) into out_dir, and
    return numpy (verts, faces) and the path.

    voxel_size: tsdf method only — fuse at this FIXED metric voxel (the
    reference's vdbfusion semantics, 0.004 m at export_mesh.py:803). When
    the implied dense grid would exceed 2^27 voxels (room-scale layouts),
    the fusion switches to the sparse brick-hash volume
    (mesh/tsdf_sparse.py). None = size the voxel from the scene extent /
    `resolution` (dense object-scale default)."""
    if method not in METHODS:
        raise ValueError(f"unknown mesh method {method!r}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = gaussians.device
    if cam_deltas is not None:
        # a camera-opt run trained the gaussians against delta-corrected
        # poses: depth rendering AND the TSDF back-projection both use the
        # same corrected viewmats (the eval path applies them too)
        camera = camera.replace(viewmat=apply_se3_delta(
            camera.viewmat, torch.as_tensor(cam_deltas, device=dev)))
    V = n_views or camera.viewmat.shape[0]
    alive = gaussians.alive
    alive_np = host(alive)
    means_np = host(gaussians.means)[alive_np]

    if method == "tsdf":
        depths, _, _ = _render_depths(gaussians, camera, rasterize_cfg, V)
        if voxel_size is not None:
            lo, hi = means_np.min(0), means_np.max(0)
            need = int(np.ceil(float((hi - lo).max()) * 1.2 / voxel_size))
            if need ** 3 > (1 << 27):
                from fusionsense_tpu_torch.mesh.tsdf_sparse import (
                    SparseTSDFConfig, fuse_depths_sparse,
                )

                vol = fuse_depths_sparse(depths, camera, SparseTSDFConfig(
                    voxel_size=voxel_size, truncation=3 * voxel_size))
                verts, faces = vol.extract_mesh()
            else:
                center = (lo + hi) / 2
                ext = need * voxel_size
                cfg = TSDFConfig(voxel_size=voxel_size,
                                 truncation=3 * voxel_size, min_weight=2.0,
                                 origin=tuple(center - ext / 2),
                                 resolution=(need,) * 3)
                tsdf, weight = fuse_depths(depths, camera, cfg)
                verts, faces = tsdf_extract(tsdf, weight, cfg)
        else:
            cfg = _auto_tsdf_cfg(means_np, resolution)
            tsdf, weight = fuse_depths(depths, camera, cfg)
            verts, faces = tsdf_extract(tsdf, weight, cfg)

    elif method == "dn":
        from fusionsense_tpu_torch.mesh.postprocess import find_depth_edges

        depths, normals, alphas = _render_depths(gaussians, camera,
                                                 rasterize_cfg, V)
        depths_np, normals_np, alphas_np = (host(depths), host(normals),
                                            host(alphas))
        pts, nrms = [], []
        for i in range(V):
            p = host(backproject_depth(depths[i], camera.index(i)))
            edge = find_depth_edges(depths_np[i]).reshape(-1)
            keep = (depths_np[i].reshape(-1) > 1e-4) & (
                alphas_np[i].reshape(-1) > 0.5) & ~edge
            pts.append(p[keep])
            n = normals_np[i].reshape(-1, 3)[keep]
            nrms.append(n / np.maximum(
                np.linalg.norm(n, axis=-1, keepdims=True), 1e-8))
        pts = np.concatenate(pts)
        nrms = np.concatenate(nrms)
        verts, faces = poisson_reconstruct(pts, nrms, poisson, device=dev)

    elif method == "sugar-coarse":
        from fusionsense_tpu_torch.mesh.level_set import (
            level_surface_from_depth,
        )

        with torch.no_grad():
            m, q, s, o, _ = activated(gaussians)
            depths, _, _ = _render_depths(gaussians, camera, rasterize_cfg, V)
            gn = gaussian_flat_normals(q, s, m, camera.index(0).origin)
            pts, nrms = [], []
            for i in range(V):
                cam_i = camera.index(i)
                p, n, valid = level_surface_from_depth(
                    depths[i], cam_i.viewmat, cam_i.fx, cam_i.fy, cam_i.cx,
                    cam_i.cy, m, q, s, o, alive, gn, width=camera.width,
                    height=camera.height, level=level, level_mode=level_mode)
                pts.append(host(p[valid]))
                nrms.append(host(n[valid]))
        pts = np.concatenate(pts)
        nrms = np.concatenate(nrms)
        if untransform is not None:
            write_ply(out_dir / f"after_clean_points_surface_level_{level}.ply",
                      untransform(pts), normals=nrms)
        verts, faces = poisson_reconstruct(pts, nrms, poisson, device=dev)

    elif method == "gaussians":
        with torch.no_grad():
            m, q, s, _, _ = activated(gaussians)
            gn = host(gaussian_flat_normals(q, s, m, camera.index(0).origin))
        pts = means_np
        nrms = gn[alive_np]
        if hull_points is not None and len(hull_points):
            from scipy.spatial import cKDTree

            d, _ = cKDTree(hull_points).query(pts)
            keep = d < 0.05
            pts, nrms = pts[keep], nrms[keep]
        verts, faces = poisson_reconstruct(pts, nrms, poisson, device=dev)

    else:   # "marching"
        from fusionsense_tpu_torch.mesh.level_set import density_grid

        lo, hi = means_np.min(0), means_np.max(0)
        extent = float((hi - lo).max()) * 1.2
        voxel = extent / resolution
        origin = tuple((lo + hi) / 2 - extent / 2)
        field = density_grid(
            gaussians.means, gaussians.quats, torch.exp(gaussians.log_scales),
            torch.sigmoid(gaussians.logit_opacities), alive,
            origin=origin, voxel_size=voxel, resolution=(resolution,) * 3)
        # inside = density above iso; the marching wants inside = below
        verts, faces = marching_tetrahedra(
            -field, iso=-0.5, origin=np.asarray(origin) + voxel / 2,
            spacing=voxel)

    if untransform is not None and len(verts):
        verts = untransform(verts).astype(np.float32)
    suffix = f"_level_{level}" if method == "sugar-coarse" else ""
    path = out_dir / f"mesh_{method}{suffix}.ply"
    write_ply(path, verts, faces=faces,
              normals=vertex_normals(verts, faces) if len(verts) else None)
    # smoothed variants, like the reference's smoothed_1/2_* Poisson outputs
    if len(verts) and method in ("sugar-coarse", "dn", "gaussians"):
        from fusionsense_tpu_torch.mesh.postprocess import laplacian_smooth

        sm = verts
        for k in (1, 2):
            sm = laplacian_smooth(sm, faces, iterations=1)
            write_ply(out_dir / f"smoothed_{k}_mesh_{method}{suffix}.ply", sm,
                      faces=faces)
    return verts, faces, path
