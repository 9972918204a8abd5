"""The benchmark's scene, made from a traffic file and a seed.

Everything here is plain torch and numpy: the harness hands these tensors to
the program, and the reference reads the same ones. Nothing comes from the
program, so the yardstick cannot move with it.

- Ring cameras looking at the origin (OpenCV world-to-camera matrices).
- The ground truth, ray-cast from an analytic textured sphere: RGB from the
  sphere's procedural texture, z-depth and world normals; the background is
  black with depth 0.
- The initial population: Fibonacci-sphere points perturbed by a seeded
  normal draw made on the device, grey, with the sphere's normals as seed
  normals, turned into Gaussian parameters as a seed point cloud is (scales
  from the mean distance of the 3 nearest neighbours, z squashed to a flat
  disc, +z rotated onto the seed normal).
- GelSight-style touch patches: spherical caps placed from the seed, with
  exact normals and PCA oriented boxes.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def look_at_w2c(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """OpenCV world-to-camera matrix looking from eye at target (float64)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ eye
    return w2c


def ring_viewmats(n_views: int, radius: float, height: float) -> np.ndarray:
    """(V, 4, 4) float32 world-to-camera matrices on a ring around 0."""
    mats = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        eye = np.array([radius * math.cos(a), radius * math.sin(a), height])
        mats.append(look_at_w2c(eye, np.zeros(3)))
    return np.stack(mats).astype(np.float32)


def cameras(traffic: dict, device) -> dict:
    """The views of a traffic file as plain tensors: viewmat (V, 4, 4),
    fx, fy, cx, cy (V,), width, height."""
    cam = traffic["cameras"]
    V, W, H = cam["views"], cam["width"], cam["height"]
    ones = torch.ones((V,), dtype=torch.float32, device=device)
    return dict(viewmat=torch.as_tensor(
        ring_viewmats(V, cam["ring_radius"], cam["ring_height"]),
        device=device),
        fx=cam["focal"] * ones, fy=cam["focal"] * ones,
        cx=(W / 2) * ones, cy=(H / 2) * ones, width=W, height=H)


def texture(unit: torch.Tensor) -> torch.Tensor:
    """The sphere's procedural colour at unit-sphere points (..., 3)."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    c = 0.5 + 0.45 * torch.stack([torch.sin(4 * x + 1), torch.sin(5 * y),
                                  torch.sin(6 * z + 2)], -1)
    return torch.clamp(c, 0.0, 1.0)


def raycast(cams: dict, radius: float):
    """Ground truth of every view, ray-cast from the textured sphere at the
    origin -> images (V, H, W, 3), depths (V, H, W), normals (V, H, W, 3)."""
    H, W = cams["height"], cams["width"]
    dev = cams["viewmat"].device
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    imgs, deps, nrms = [], [], []
    for v in range(cams["viewmat"].shape[0]):
        vm = cams["viewmat"][v]
        R, t = vm[:3, :3], vm[:3, 3]
        origin = -(R.T @ t)
        d_cam = torch.stack([(gx - cams["cx"][v]) / cams["fx"][v],
                             (gy - cams["cy"][v]) / cams["fy"][v],
                             torch.ones_like(gx)], -1)
        dirs = d_cam @ R             # rows of R.T @ d: camera to world
        dn = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        b = torch.sum(dn * origin, -1)
        c = torch.sum(origin * origin) - radius ** 2
        disc = b * b - c
        tt = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        hit = (disc > 0) & (tt > 0)
        pts = origin + tt[..., None] * dn
        unit = pts / radius
        z = (pts @ R.T + t)[..., 2]
        m = hit[..., None]
        imgs.append(torch.where(m, texture(unit), torch.zeros_like(unit)))
        deps.append(torch.where(hit, z, torch.zeros_like(z)))
        nrms.append(torch.where(m, unit, torch.zeros_like(unit)))
    return torch.stack(imgs), torch.stack(deps), torch.stack(nrms)


def fibonacci_dirs(n: int) -> np.ndarray:
    """(n, 3) float64 unit vectors of a Fibonacci sphere."""
    i = np.arange(n, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1 - y * y, 0))
    theta = phi * i
    return np.stack([r * np.cos(theta), r * np.sin(theta), y], axis=-1)


def seed_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def initial_points(pop: dict, radius: float, seed: int, device):
    """The seed cloud -> (points (N, 3), normals (N, 3)): the Fibonacci
    sphere, each point moved by sigma * N(0, 1) drawn on the device."""
    dirs = torch.as_tensor(fibonacci_dirs(pop["points"]).astype(np.float32),
                           device=device)
    noise = torch.randn(dirs.shape, generator=seed_generator(seed, device),
                        device=device)
    return radius * dirs + pop["sigma"] * noise, dirs


def knn_mean_dist(points: torch.Tensor, k: int = 3,
                  chunk: int = 4096) -> torch.Tensor:
    """(N, 3) -> (N,) mean distance to the k nearest other points."""
    n = points.shape[0]
    sq = torch.sum(points * points, -1)
    out = []
    for s in range(0, n, chunk):
        p = points[s:s + chunk]
        d2 = sq[s:s + chunk, None] - 2.0 * (p @ points.T) + sq[None, :]
        rows = torch.arange(p.shape[0], device=points.device)
        d2[rows, rows + s] = math.inf
        near = torch.topk(d2, k, dim=-1, largest=False).values
        out.append(torch.mean(torch.sqrt(torch.clamp_min(near, 1e-12)), -1))
    return torch.cat(out)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


def rotation_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions turning unit vectors a onto b; antiparallel pairs
    turn 180 degrees about an orthogonal axis."""
    a, b = _normalize(a), _normalize(b)
    c = torch.linalg.cross(a, b, dim=-1)
    d = torch.sum(a * b, -1, keepdim=True)
    q = torch.cat([1.0 + d, c], -1)
    ex = torch.tensor([1.0, 0.0, 0.0], device=a.device).expand_as(a)
    ey = torch.tensor([0.0, 1.0, 0.0], device=a.device).expand_as(a)
    ortho = torch.where(torch.abs(a[..., :1]) < 0.9,
                        torch.linalg.cross(a, ex, dim=-1),
                        torch.linalg.cross(a, ey, dim=-1))
    q_anti = torch.cat([torch.zeros_like(d), _normalize(ortho)], -1)
    return _normalize(torch.where(d < -1.0 + 1e-6, q_anti, q))


def initial_params(points: torch.Tensor, normals: torch.Tensor, *,
                   sh_degree: int, init_opacity: float,
                   flat_z_ratio: float = 0.1) -> dict:
    """Gaussian parameters of a grey seed cloud with seed normals (N rows):
    means, quats, log_scales, logit_opacities, features_dc, features_rest,
    normals."""
    n = points.shape[0]
    dist = knn_mean_dist(points)
    scales = torch.stack([dist, dist, dist * flat_z_ratio], -1)
    ez = torch.zeros_like(normals)
    ez[:, 2] = 1.0
    K = (sh_degree + 1) ** 2
    return dict(
        means=points.clone(),
        quats=rotation_between(ez, normals),
        log_scales=torch.log(torch.clamp_min(scales, 1e-8)),
        logit_opacities=torch.full(
            (n,), math.log(init_opacity / (1.0 - init_opacity)),
            device=points.device),
        features_dc=torch.zeros((n, 3), device=points.device),  # grey 0.5
        features_rest=torch.zeros((n, K - 1, 3), device=points.device),
        normals=_normalize(normals))


def oriented_bbox(points: np.ndarray, pad: float):
    """PCA oriented box: (center, R (rows = axes), half-extents)."""
    center = points.mean(axis=0)
    x = points - center
    cov = x.T @ x / max(len(points), 1)
    _, vecs = np.linalg.eigh(cov)
    R = vecs.T[::-1].copy()
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    ext = np.abs(x @ R.T).max(axis=0) + pad
    return center, R, ext


def touch_patches(touch: dict, radius: float, seed: int) -> list[dict]:
    """Spherical caps on the sphere, placed from the seed: each a dict of
    numpy points, colors, normals, bbox_center, bbox_rot, bbox_extent."""
    rng = np.random.RandomState(seed % (1 << 32))
    n_pts, cap = touch["points_per_patch"], np.deg2rad(touch["cap_deg"])
    out = []
    for k in range(touch["patches"]):
        theta = 2 * np.pi * (k / touch["patches"] + 0.1)
        phi = np.pi / 2 + rng.uniform(-0.6, 0.6)
        c = np.array([np.sin(phi) * np.cos(theta),
                      np.sin(phi) * np.sin(theta), np.cos(phi)])
        t1 = np.cross([0.0, 0.0, 1.0], c)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(c, t1)
        a = np.sqrt(rng.rand(n_pts)) * cap
        b = rng.rand(n_pts) * 2 * np.pi
        dirs = (np.cos(a)[:, None] * c[None]
                + np.sin(a)[:, None] * (np.cos(b)[:, None] * t1[None]
                                        + np.sin(b)[:, None] * t2[None]))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pts = (radius * dirs).astype(np.float32)
        center, R, ext = oriented_bbox(pts, pad=touch["bbox_pad"])
        out.append(dict(points=pts, colors=np.full_like(pts, touch["color"]),
                        normals=dirs.astype(np.float32),
                        bbox_center=center.astype(np.float32),
                        bbox_rot=R.astype(np.float32),
                        bbox_extent=ext.astype(np.float32)))
    return out


def make(traffic: dict, *, sh_degree: int, init_opacity: float, seed: int,
         device) -> dict:
    """Everything a run hands to both sides: cams, images, depths, normals,
    params0 (N rows), patches (list, maybe empty)."""
    radius = traffic["object"]["radius"]
    cams = cameras(traffic, device)
    images, depths, normals = raycast(cams, radius)
    pts, nrm = initial_points(traffic["population"], radius, seed, device)
    params0 = initial_params(pts, nrm, sh_degree=sh_degree,
                             init_opacity=init_opacity)
    touch = traffic.get("touch")
    patches = touch_patches(touch, radius, seed) if touch else []
    return dict(cams=cams, images=images, depths=depths, normals=normals,
                params0=params0, patches=patches)
