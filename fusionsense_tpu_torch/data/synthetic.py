"""Procedural test scenes: ring cameras around a textured sphere,
GelSight-style touch patches on it, the bumpy "blob" and the non-convex
"hard" object.

Counterpart of fusionsense_tpu/data/synthetic.py. The sphere geometry is
computed with numpy in float64 and cast to float32, exactly as the JAX
package does, so both packages build the same scene. The blob and hard
objects are implicit surfaces evaluated in float32 torch on the camera's
(or the caller's) device; their normals are the implicit function's
gradient by autograd, where JAX takes jax.grad.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera, make_camera
from fusionsense_tpu_torch.device import resolve_device


def look_at_w2c(eye: np.ndarray, target: np.ndarray, up=(0, 0, 1)) -> np.ndarray:
    """OpenCV world-to-camera matrix looking from eye at target."""
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


def ring_cameras(n_views: int = 9, radius: float = 2.0, height: float = 0.8,
                 width: int = 128, height_px: int = 96, focal: float = 110.0,
                 target=(0.0, 0.0, 0.0), device=None) -> Camera:
    """Batched Camera: n_views on a ring looking at the target."""
    tgt = np.asarray(target, np.float64)
    mats = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        eye = np.array([radius * math.cos(a), radius * math.sin(a), height])
        mats.append(look_at_w2c(eye, tgt))
    ones = np.ones((n_views,), np.float32)
    return make_camera(np.stack(mats).astype(np.float32), focal * ones,
                       focal * ones, (width / 2) * ones, (height_px / 2) * ones,
                       width, height_px, device=device)


def sphere_points(n: int = 2000, radius: float = 0.5, seed: int = 0,
                  device=None):
    """Fibonacci-sphere points, a procedural color texture and normals.
    (`seed` is accepted for signature parity; the points are deterministic.)"""
    dev = resolve_device(device)
    i = np.arange(n, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1 - y * y, 0))
    theta = phi * i
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), y], axis=-1)
    colors = 0.5 + 0.45 * np.stack(
        [np.sin(4 * pts[:, 0] + 1), np.sin(5 * pts[:, 1]),
         np.sin(6 * pts[:, 2] + 2)], axis=-1)
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    return f32(pts * radius), f32(np.clip(colors, 0, 1)), f32(pts.copy())


def sphere_depth_normals(camera: Camera, center=(0.0, 0.0, 0.0),
                         radius: float = 0.5):
    """Analytic ray-traced z-depth + world normals of the GT sphere for ONE
    camera. Returns (depth (H, W), normal (H, W, 3), mask (H, W))."""
    H, W = camera.height, camera.width
    dev = camera.device
    c2w = camera.camtoworld
    origin = camera.origin
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs_cam = torch.stack([(gx - camera.cx) / camera.fx,
                            (gy - camera.cy) / camera.fy,
                            torch.ones_like(gx)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dn = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    ctr = torch.tensor(center, dtype=torch.float32, device=dev)
    oc = origin - ctr
    b = torch.sum(dn * oc, -1)
    c = torch.sum(oc * oc) - radius ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    pts = origin + t[..., None] * dn
    normal = (pts - ctr) / radius
    z = (pts @ camera.viewmat[:3, :3].T + camera.viewmat[:3, 3])[..., 2]
    depth = torch.where(hit, z, torch.zeros_like(z))
    normal = torch.where(hit[..., None], normal, torch.zeros_like(normal))
    return depth, normal, hit.to(torch.float32)


def sphere_touch_patches(n_patches=4, pts_per_patch=400, radius=0.5,
                         cap_deg=8.0, seed=7):
    """Synthetic GelSight-style patches on the analytic sphere: small
    spherical caps with exact surface normals and PCA oriented bboxes
    (numpy TouchPatch objects, the same numbers as the JAX package's)."""
    from fusionsense_tpu_torch.data.tactile import TouchPatch, oriented_bbox

    rng = np.random.RandomState(seed)
    patches = []
    for k in range(n_patches):
        theta = 2 * np.pi * (k / n_patches + 0.1)
        phi = np.pi / 2 + rng.uniform(-0.6, 0.6)
        c = np.array([np.sin(phi) * np.cos(theta),
                      np.sin(phi) * np.sin(theta), np.cos(phi)])
        up = np.array([0.0, 0.0, 1.0])
        t1 = np.cross(up, c)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(c, t1)
        ang = np.deg2rad(cap_deg)
        a = np.sqrt(rng.rand(pts_per_patch)) * ang
        b = rng.rand(pts_per_patch) * 2 * np.pi
        dirs = (np.cos(a)[:, None] * c[None]
                + np.sin(a)[:, None] * (np.cos(b)[:, None] * t1[None]
                                        + np.sin(b)[:, None] * t2[None]))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pts = (radius * dirs).astype(np.float32)
        center, R, ext = oriented_bbox(pts, pad=2e-3)
        patches.append(TouchPatch(
            points=pts, colors=np.full_like(pts, 0.6),
            normals=dirs.astype(np.float32), bbox_center=center,
            bbox_rot=R, bbox_extent=ext))
    return patches


# ---------------------------------------------------------------- blob ----
#
# A star-convex "bunny-class" test object: smooth radial perturbation of a
# sphere with genus-0 bumps and dents, exact autodiff normals.

def _blob_radius(u: torch.Tensor, base: float = 0.4) -> torch.Tensor:
    """(..., 3) unit directions -> (...,) radius of the blob surface."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    bump = (0.16 * torch.sin(3.0 * x + 1.0) * torch.sin(2.0 * y)
            + 0.12 * (x * x - y * y) * z
            + 0.10 * torch.sin(4.0 * z)
            + 0.08 * x * y)
    return base * (1.0 + bump)


def _blob_implicit(p: torch.Tensor, base: float = 0.4) -> torch.Tensor:
    r = torch.linalg.norm(p, dim=-1)
    u = p / torch.clamp_min(r, 1e-9)[..., None]
    return r - _blob_radius(u, base)


def _implicit_grad(implicit, pts: torch.Tensor) -> torch.Tensor:
    """Per-point gradient of a pointwise implicit function."""
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(implicit(p).sum(), p)
    return g


def _fib_dirs(n: int, dev) -> torch.Tensor:
    i = np.arange(n, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    yy = 1 - 2 * (i + 0.5) / n
    rr = np.sqrt(np.maximum(1 - yy * yy, 0))
    th = phi * i
    u = np.stack([rr * np.cos(th), rr * np.sin(th), yy], -1)
    return torch.as_tensor(u.astype(np.float32), device=dev)


def _texture(p: torch.Tensor) -> torch.Tensor:
    """The procedural albedo shared by geometry samples and shading."""
    c = 0.5 + 0.45 * torch.stack(
        [torch.sin(7 * p[..., 0] + 1), torch.sin(9 * p[..., 1] * p[..., 2]),
         torch.sin(8 * p[..., 2] + 2)], -1)
    return torch.clamp(c, 0, 1)


def blob_points(n: int = 4000, base: float = 0.4, seed: int = 0, device=None):
    """Surface samples of the blob: (points, colors, normals); normals are
    the exact implicit-function gradient. (`seed` is accepted for signature
    parity; the points are deterministic.)"""
    u = _fib_dirs(n, resolve_device(device))
    pts = u * _blob_radius(u, base)[..., None]
    grad = _implicit_grad(lambda p: _blob_implicit(p, base), pts)
    normals = grad / torch.linalg.norm(grad, dim=-1, keepdim=True)
    return pts, _texture(pts), normals


def _pixel_rays(camera: Camera):
    """Unit world directions (H, W, 3) through the pixel centres."""
    H, W = camera.height, camera.width
    dev = camera.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dirs_cam = torch.stack([(gx - camera.cx) / camera.fx,
                            (gy - camera.cy) / camera.fy,
                            torch.ones_like(gx)], -1)
    dirs = dirs_cam @ camera.camtoworld[:3, :3].T
    return dirs, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def _linspace(t0: torch.Tensor, t1: torch.Tensor, n: int) -> torch.Tensor:
    """n samples from t0 to t1 by the JAX package's rule: t0 (1 - s) + t1 s
    with s = i / (n - 1), the last sample exactly t1."""
    s = torch.arange(n - 1, dtype=torch.float32, device=t0.device) / (n - 1)
    return torch.cat([t0 * (1 - s) + t1 * s, t1.reshape(1)])


def _first_crossing(origin, dn, implicit, ts, rounds: int):
    """First outside -> inside crossing along each ray over the samples ts,
    refined by `rounds` bisections. Returns (t, hit)."""
    vals = torch.stack([implicit(origin + t * dn) for t in ts])
    outside = vals > 0                                   # (S, H, W)
    cross = outside[:-1] & ~outside[1:]
    any_hit = torch.any(cross, dim=0)
    first = torch.argmax(cross.to(torch.int8), dim=0)
    ta, tb = ts[first], ts[first + 1]
    for _ in range(rounds):
        tm = 0.5 * (ta + tb)
        go_lo = implicit(origin + tm[..., None] * dn) > 0
        ta = torch.where(go_lo, tm, ta)
        tb = torch.where(go_lo, tb, tm)
    return 0.5 * (ta + tb), any_hit


def _hit_outputs(camera: Camera, implicit, origin, dn, t):
    pts = origin + t[..., None] * dn
    H, W = camera.height, camera.width
    grad = _implicit_grad(implicit, pts.reshape(-1, 3)).reshape(H, W, 3)
    normal = grad / torch.clamp_min(
        torch.linalg.norm(grad, dim=-1, keepdim=True), 1e-9)
    z = (pts @ camera.viewmat[:3, :3].T + camera.viewmat[:3, 3])[..., 2]
    return pts, normal, z


def blob_depth_normals(camera: Camera, base: float = 0.4, n_steps: int = 48):
    """Ray-marched z-depth + exact world normals + mask of the blob for ONE
    camera (bracketed around the bounding spheres, 10 bisections)."""
    origin = camera.origin
    _, dn = _pixel_rays(camera)
    oc = torch.linalg.norm(origin)
    ts = _linspace(torch.clamp_min(oc - 1.6 * base, 1e-3), oc + 1.6 * base,
                   n_steps)
    implicit = lambda p: _blob_implicit(p, base)  # noqa: E731
    t, any_hit = _first_crossing(origin, dn, implicit, ts, 10)
    _, normal, z = _hit_outputs(camera, implicit, origin, dn, t)
    depth = torch.where(any_hit, z, torch.zeros_like(z))
    normal = torch.where(any_hit[..., None], normal, torch.zeros_like(normal))
    return depth, normal, any_hit.to(torch.float32)


# --------------------------------------------------------------------------
# "hard" capture: non-convex geometry + specular shading + clutter

_HANDLE_C = (0.0, 0.47, 0.0)     # torus handle center (+y side)
_HANDLE_R, _HANDLE_r = 0.16, 0.05
_DENT_C = (-0.44, 0.0, 0.0)      # concave dent (-x side)
_DENT_R = 0.13


def _hard_implicit(p: torch.Tensor, base: float = 0.4) -> torch.Tensor:
    """Blob with a torus handle, minus a spherical dent: non-convex (a hole
    through the handle, a cavity at -x), not star-convex."""
    b = _blob_implicit(p, base)
    q = p - torch.tensor(_HANDLE_C, dtype=p.dtype, device=p.device)
    ring = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2) - _HANDLE_R
    torus = torch.sqrt(ring ** 2 + q[..., 2] ** 2) - _HANDLE_r
    dent = _DENT_R - torch.linalg.norm(
        p - torch.tensor(_DENT_C, dtype=p.dtype, device=p.device), dim=-1)
    return torch.maximum(torch.minimum(b, torus), dent)


def _march_implicit(camera: Camera, implicit, t_lo, t_hi, n_steps: int):
    """First-crossing ray march + 12 bisections against any implicit.
    Returns (pts (H, W, 3), normal, z-depth, hit-mask)."""
    origin = camera.origin
    _, dn = _pixel_rays(camera)
    t, any_hit = _first_crossing(origin, dn, implicit,
                                 _linspace(t_lo, t_hi, n_steps), 12)
    pts, normal, z = _hit_outputs(camera, implicit, origin, dn, t)
    return pts, normal, torch.where(any_hit, z, torch.zeros_like(z)), any_hit


def _hard_bracket(camera: Camera, base: float):
    oc = torch.linalg.norm(camera.origin)
    return torch.clamp_min(oc - 1.9 * base, 1e-3), oc + 1.9 * base


def hard_depth_normals(camera: Camera, base: float = 0.4, n_steps: int = 96):
    """Ray-marched depth/normal/mask of the hard (non-convex) object."""
    _, normal, depth, hit = _march_implicit(
        camera, lambda p: _hard_implicit(p, base), *_hard_bracket(camera, base),
        n_steps)
    return (depth, torch.where(hit[..., None], normal, torch.zeros_like(normal)),
            hit.to(torch.float32))


def hard_points(n: int = 6000, base: float = 0.4, seed: int = 0, device=None):
    """Surface samples of the hard object: candidate soup (blob shell +
    torus shell + dent shell) Newton-projected onto the union surface."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    b_pts, _, _ = blob_points(n=n, base=base, seed=seed, device=dev)
    th = rng.rand(n // 3) * 2 * np.pi
    ph = rng.rand(n // 3) * 2 * np.pi
    ring = _HANDLE_R + _HANDLE_r * np.cos(ph)
    t_pts = np.stack([ring * np.cos(th), ring * np.sin(th),
                      _HANDLE_r * np.sin(ph)], -1) + np.asarray(_HANDLE_C)
    u = rng.randn(n // 3, 3)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d_pts = np.asarray(_DENT_C) + u * _DENT_R
    cand = torch.cat([b_pts, torch.as_tensor(
        np.concatenate([t_pts, d_pts]).astype(np.float32), device=dev)])

    f = lambda p: _hard_implicit(p, base)  # noqa: E731
    for _ in range(12):                       # Newton projection onto f = 0
        v = f(cand)
        g = _implicit_grad(f, cand)
        cand = cand - g * (v / torch.clamp_min(torch.sum(g * g, -1), 1e-9)
                           )[:, None]
    pts = cand[torch.abs(f(cand)) < 1e-4]
    g = _implicit_grad(f, pts)
    normals = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    return pts, _texture(pts), normals


_LIGHT = (1.5, 1.0, 2.2)


def shade_hard_view(camera: Camera, base: float = 0.4,
                    spec_strength: float = 0.6, shininess: float = 40.0,
                    wall_radius: float = 2.6):
    """Shaded capture of the hard object for ONE camera: textured diffuse +
    a strong Blinn-Phong specular lobe (point light) over a checkered
    cylinder wall. Returns (rgb, depth_with_background, object_mask)."""
    origin = camera.origin
    dev = camera.device
    pts, normal, z_obj, hit = _march_implicit(
        camera, lambda p: _hard_implicit(p, base),
        *_hard_bracket(camera, base), 96)

    unit = lambda v: v / torch.linalg.norm(v, dim=-1, keepdim=True)  # noqa: E731
    light = torch.tensor(_LIGHT, dtype=torch.float32, device=dev)
    l_dir = unit(light - pts)
    v = unit(origin - pts)
    h = l_dir + v
    h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True), 1e-9)
    lam = torch.clamp_min(torch.sum(normal * l_dir, -1), 0.0)
    spec = spec_strength * torch.clamp_min(torch.sum(normal * h, -1),
                                           0.0) ** shininess
    rgb_obj = torch.clamp(
        _texture(pts) * (0.25 + 0.75 * lam)[..., None] + spec[..., None], 0, 1)

    dirs, _ = _pixel_rays(camera)
    a = dirs[..., 0] ** 2 + dirs[..., 1] ** 2
    bq = 2 * (origin[0] * dirs[..., 0] + origin[1] * dirs[..., 1])
    cq = origin[0] ** 2 + origin[1] ** 2 - wall_radius ** 2
    disc = torch.clamp_min(bq ** 2 - 4 * a * cq, 0.0)
    t_wall = (-bq + torch.sqrt(disc)) / torch.clamp_min(2 * a, 1e-9)
    p_wall = origin + t_wall[..., None] * dirs
    check = torch.remainder(
        torch.floor(p_wall[..., 2] * 4)
        + torch.floor(torch.atan2(p_wall[..., 1], p_wall[..., 0]) * 5), 2)
    rgb_bg = torch.stack([0.25 + 0.45 * check, 0.35 - 0.1 * check,
                          0.30 + 0.25 * check], -1)
    z_wall = (p_wall @ camera.viewmat[:3, :3].T + camera.viewmat[:3, 3])[..., 2]

    rgb = torch.where(hit[..., None], rgb_obj, rgb_bg)
    depth = torch.where(hit, z_obj, z_wall)    # the sensor sees the wall too
    return rgb, depth, hit.to(torch.float32)
