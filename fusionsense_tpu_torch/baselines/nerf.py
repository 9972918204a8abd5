"""Baseline NeRF family: hash-grid radiance field with depth/normal
regularization.

Counterpart of fusionsense_tpu/baselines/nerf.py. The reference ships three
regularized-NeRF baselines for paper comparisons (reference
dn_splatter/eval/baseline_models/: g-nerfacto, g-depthnerfacto,
g-neusfacto); this is one configurable model covering that family:

- multiresolution hash encoding (instant-NGP style) as gathers,
- small density + color MLPs (a plain dict of tensors with the JAX
  package's keys, no framework),
- stratified ray sampling + volume rendering (RGB, expected depth,
  density-gradient normals),
- loss flags select the variant: rgb-only (nerfacto), +depth
  (depthnerfacto), +normal-from-gradient supervision (neusfacto-style),
- Adam as optax.adam(lr) computes it (b1 0.9, b2 0.999, eps 1e-8).

The hash is JAX's uint32 arithmetic in int64: corners saturate to
[0, 2^32 - 1] as a float -> uint32 cast does, products keep their low 32
bits. Randomness is explicit: the sample offsets `u` and the ray indices
are tensors, drawn by `draw_rays` from a torch.Generator (or given, so the
JAX package's draws can be replayed). A chunk of steps is a Python loop.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.device import resolve_device

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    n_levels: int = 12
    table_size_log2: int = 17
    features_per_level: int = 2
    base_res: int = 16
    max_res: int = 512
    mlp_width: int = 64
    n_samples: int = 64
    near: float = 0.2
    far: float = 4.0
    scene_bound: float = 1.0       # hash grid covers [-bound, bound]^3
    rgb_lambda: float = 1.0
    depth_lambda: float = 0.0      # >0 -> depthnerfacto
    normal_lambda: float = 0.0     # >0 -> neusfacto-style
    lr: float = 5e-3
    rays_per_step: int = 4096


def init_params(generator: torch.Generator, cfg: NerfConfig,
                device=None) -> dict:
    """Fresh params on `device` (the card by default), drawn from
    `generator` (on that device): the table from U(-1e-4, 1e-4), dense
    kernels from N(0, 2 / fan_in), zero biases."""
    dev = resolve_device(device)
    T = 1 << cfg.table_size_log2
    w = cfg.mlp_width

    def dense(i, o):
        return {"w": torch.randn((i, o), generator=generator, device=dev)
                * (2.0 / i) ** 0.5,
                "b": torch.zeros((o,), device=dev)}

    table = torch.rand((cfg.n_levels, T, cfg.features_per_level),
                       generator=generator, device=dev) * 2e-4 - 1e-4
    return {"table": table,
            "d1": dense(cfg.n_levels * cfg.features_per_level, w),
            "d2": dense(w, w),
            "density_head": dense(w, 1 + 15),   # density + geo features
            "c1": dense(15 + 3, w),
            "c2": dense(w, 3)}


def _hash(corner: torch.Tensor, T: int) -> torch.Tensor:
    """(R, 3) integral float corners -> (R,) table rows, as JAX's
    `(corner.astype(uint32) * primes).astype(uint32)`, XOR, mod T."""
    # clamped in float first: a float past int64's range has no int64 value
    c = torch.clamp(corner, 0, 2.0 ** 32).to(torch.int64).clamp_max(_U32)
    h = [(c[:, i] * p) & _U32 for i, p in enumerate(_PRIMES)]
    return (h[0] ^ h[1] ^ h[2]) & (T - 1)


def _hash_encode(points: torch.Tensor, table: torch.Tensor,
                 cfg: NerfConfig) -> torch.Tensor:
    """(R, 3) in [-bound, bound] -> (R, n_levels * F) trilinear hash feats."""
    L, T, _ = table.shape
    x = (points / cfg.scene_bound + 1.0) * 0.5          # [0, 1]
    growth = (cfg.max_res / cfg.base_res) ** (1.0 / max(L - 1, 1))
    corners = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    offsets = torch.tensor(corners, dtype=x.dtype, device=x.device)
    feats = []
    for lvl in range(L):
        xs = x * (cfg.base_res * growth ** lvl)
        x0 = torch.floor(xs)
        f = xs - x0
        acc = 0.0
        for (dx, dy, dz), d in zip(corners, offsets):
            idx = _hash(x0 + d, T)
            wgt = (torch.abs(1 - dx - f[:, 0]) * torch.abs(1 - dy - f[:, 1])
                   * torch.abs(1 - dz - f[:, 2]))
            acc = acc + wgt[:, None] * table[lvl][idx]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def _mlp(params, name, x, act=F.relu):
    p = params[name]
    y = x @ p["w"] + p["b"]
    return act(y) if act is not None else y


def density_and_features(params, points, cfg: NerfConfig):
    enc = _hash_encode(points, params["table"], cfg)
    h = _mlp(params, "d1", enc)
    h = _mlp(params, "d2", h)
    out = _mlp(params, "density_head", h, act=None)
    return F.softplus(out[:, 0] - 1.0), out[:, 1:]


def color(params, geo_feats, dirs):
    h = _mlp(params, "c1", torch.cat([geo_feats, dirs], dim=-1))
    return torch.sigmoid(_mlp(params, "c2", h, act=None))


def render_rays(params, origins, dirs, u, cfg: NerfConfig,
                with_normals: bool = False):
    """(R, 3) origins/dirs and (R, n_samples) offsets in [0, 1) -> dict(rgb
    (R, 3), depth (R,), acc (R,), weights, ts, normal (R, 3) optional).
    Stratified sampling + volume rendering. With normals, the sample
    points' density gradient is taken with create_graph, so a normal loss
    trains through it."""
    R = origins.shape[0]
    S = cfg.n_samples
    t = torch.linspace(cfg.near, cfg.far, S + 1, dtype=origins.dtype,
                       device=origins.device)
    lo, hi = t[:-1], t[1:]
    ts = lo[None, :] + (hi - lo)[None, :] * u                  # (R, S)
    pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    flat = pts.reshape(-1, 3)
    if with_normals:
        flat = flat.detach().requires_grad_(True)

    with torch.enable_grad() if with_normals else contextlib.nullcontext():
        density, geo = density_and_features(params, flat, cfg)
        if with_normals:
            (grad,) = torch.autograd.grad(density.sum(), flat,
                                          create_graph=True)
    dirs_rep = torch.repeat_interleave(dirs, S, dim=0)
    rgb = color(params, geo, dirs_rep).reshape(R, S, 3)
    sigma = density.reshape(R, S)

    delta = torch.diff(ts, dim=-1, append=ts[:, -1:] + (cfg.far - cfg.near) / S)
    alpha = 1.0 - torch.exp(-sigma * delta)
    log_t = torch.log1p(-torch.clamp(alpha, 0.0, 0.999))
    cum = torch.cumsum(log_t, dim=-1)
    trans = torch.exp(cum - log_t)
    w = alpha * trans                                          # (R, S)

    out = {
        "rgb": torch.sum(w[..., None] * rgb, dim=1),
        "depth": torch.sum(w * ts, dim=1),
        "acc": torch.sum(w, dim=1),
        "weights": w,
        "ts": ts,
    }
    if with_normals:
        grad = grad.reshape(R, S, 3)
        n = -grad / torch.clamp_min(
            torch.linalg.norm(grad, dim=-1, keepdim=True), 1e-8)
        out["normal"] = torch.sum(w[..., None] * n, dim=1)
    return out


@dataclasses.dataclass
class RayDraw:
    """One step's random draws: view, row and column per ray, and the
    stratified offsets (rays, n_samples)."""
    vi: torch.Tensor
    py: torch.Tensor
    px: torch.Tensor
    u: torch.Tensor


def draw_rays(generator: torch.Generator, cfg: NerfConfig, n_views: int,
              height: int, width: int, device) -> RayDraw:
    """A step's draws from `generator` (on `device`)."""
    n, kw = cfg.rays_per_step, dict(generator=generator, device=device)
    return RayDraw(vi=torch.randint(0, n_views, (n,), **kw),
                   py=torch.randint(0, height, (n,), **kw),
                   px=torch.randint(0, width, (n,), **kw),
                   u=torch.rand((n, cfg.n_samples), **kw))


def sample_rays(camera: Camera, images, depths, normals, vi, py, px):
    """The rays through pixels (vi, py, px) of the views. Returns origins,
    dirs (world), target rgb/depth/normal."""
    c2w = torch.linalg.inv(camera.viewmat)                     # (V, 4, 4)
    fx, fy = camera.fx[vi], camera.fy[vi]
    cx, cy = camera.cx[vi], camera.cy[vi]
    d_cam = torch.stack([(px + 0.5 - cx) / fx, (py + 0.5 - cy) / fy,
                         torch.ones_like(fx)], dim=-1)
    dirs = torch.einsum("nij,nj->ni", c2w[vi, :3, :3], d_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = c2w[vi, :3, 3]
    tgt = {
        "rgb": images[vi, py, px],
        "depth": depths[vi, py, px] if depths is not None else None,
        "normal": normals[vi, py, px] if normals is not None else None,
    }
    return origins, dirs, tgt


def loss_fn(params, draw: RayDraw, cfg: NerfConfig, camera: Camera, images,
            depths=None, normals=None):
    """(loss, psnr) of one step's rays, as the JAX package's train step
    computes them."""
    want_normals = cfg.normal_lambda > 0 and normals is not None
    origins, dirs, tgt = sample_rays(camera, images, depths, normals,
                                     draw.vi, draw.py, draw.px)
    out = render_rays(params, origins, dirs, draw.u, cfg,
                      with_normals=want_normals)
    mse = torch.mean((out["rgb"] - tgt["rgb"]) ** 2)
    loss = cfg.rgb_lambda * mse
    if cfg.depth_lambda > 0 and tgt["depth"] is not None:
        # euclidean ray depth from the z-depth target
        valid = tgt["depth"] > 1e-4
        loss = loss + cfg.depth_lambda * torch.sum(torch.where(
            valid, torch.log1p(torch.abs(out["depth"] - tgt["depth"])),
            0.0)) / torch.clamp_min(torch.sum(valid), 1)
    if want_normals:
        valid = torch.linalg.norm(tgt["normal"], dim=-1) > 0.5
        loss = loss + cfg.normal_lambda * torch.sum(torch.where(
            valid, torch.sum(torch.abs(out["normal"] - tgt["normal"]), -1),
            0.0)) / torch.clamp_min(torch.sum(valid), 1)
    psnr = -10 * torch.log10(mse + 1e-10)
    return loss, psnr


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(pairs) -> dict:
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def adam_init(params: dict) -> dict:
    zeros = lambda: _unflatten(  # noqa: E731
        (p, torch.zeros_like(v)) for p, v in _leaves(params))
    return {"mu": zeros(), "nu": zeros(), "count": 0}


def adam_update(params: dict, grads: dict, state: dict, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.adam(lr)'s update applied: (new params, new state)."""
    count = state["count"] + 1
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    mu, nu, new = [], [], []
    for (path, x), (_, g), (_, m), (_, v) in zip(
            _leaves(params), _leaves(grads), _leaves(state["mu"]),
            _leaves(state["nu"])):
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * g * g + b2 * v
        mu.append((path, m))
        nu.append((path, v))
        new.append((path, x + (-lr) * ((m / c1) / (torch.sqrt(v / c2) + eps))))
    return _unflatten(new), {"mu": _unflatten(mu), "nu": _unflatten(nu),
                             "count": count}


def loss_and_grads(params, draw: RayDraw, cfg: NerfConfig, camera: Camera,
                   images, depths=None, normals=None):
    """(loss, psnr, grads) of one step, grads a dict shaped like params."""
    pairs = list(_leaves(params))
    leaves = [v.detach().requires_grad_(True) for _, v in pairs]
    p = _unflatten((path, v) for (path, _), v in zip(pairs, leaves))
    with torch.enable_grad():
        loss, psnr = loss_fn(p, draw, cfg, camera, images, depths, normals)
        gs = torch.autograd.grad(loss, leaves)
    return (loss.detach(), psnr.detach(),
            _unflatten((path, g) for (path, _), g in zip(pairs, gs)))


def make_train_step(cfg: NerfConfig, camera: Camera, images, depths=None,
                    normals=None):
    """(adam_init, train_chunk): train_chunk(params, opt_state, draws) runs
    one Adam step per RayDraw and returns (params, opt_state, metrics
    {"loss": (n,), "psnr": (n,)}), the metrics left on the device."""

    def train_chunk(params, opt_state, draws):
        losses, psnrs = [], []
        for draw in draws:
            loss, psnr, grads = loss_and_grads(params, draw, cfg, camera,
                                               images, depths, normals)
            params, opt_state = adam_update(params, grads, opt_state, cfg.lr)
            losses.append(loss)
            psnrs.append(psnr)
        return params, opt_state, {"loss": torch.stack(losses),
                                   "psnr": torch.stack(psnrs)}

    return adam_init, train_chunk


def render_image(params, camera: Camera, cfg: NerfConfig, u=None,
                 chunk: int = 8192):
    """Full-image render of one view (a loop over ray chunks). `u` is the
    (chunk, n_samples) offsets every chunk uses, as the JAX package reuses
    one key; by default drawn from a generator seeded 0. Returns numpy
    arrays."""
    like = dict(dtype=camera.viewmat.dtype, device=camera.viewmat.device)
    H, W = camera.height, camera.width
    c2w = torch.linalg.inv(camera.viewmat)
    ys, xs = torch.meshgrid(torch.arange(H, **like) + 0.5,
                            torch.arange(W, **like) + 0.5, indexing="ij")
    d_cam = torch.stack([(xs - camera.cx) / camera.fx,
                         (ys - camera.cy) / camera.fy,
                         torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    dirs = d_cam @ c2w[:3, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = c2w[:3, 3].expand(dirs.shape)
    if u is None:
        gen = torch.Generator(device=dirs.device).manual_seed(0)
        u = torch.rand((chunk, cfg.n_samples), generator=gen, **like)

    n = dirs.shape[0]
    pad = (-n) % chunk
    o = torch.cat([origins, torch.zeros((pad, 3), **like)])
    d = torch.cat([dirs, torch.ones((pad, 3), **like)])
    rgb, depth = [], []
    with torch.no_grad():
        for i in range(0, n + pad, chunk):
            out = render_rays(params, o[i:i + chunk], d[i:i + chunk], u, cfg)
            rgb.append(out["rgb"])
            depth.append(out["depth"])
    return {"rgb": torch.cat(rgb)[:n].reshape(H, W, 3).cpu().numpy(),
            "depth": torch.cat(depth)[:n].reshape(H, W).cpu().numpy()}
