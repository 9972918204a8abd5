"""Plain 3D Gaussian splatting: projection, SH colour and tile compositing.

Written from the published algorithm (Kerbl et al. 2023, "3D Gaussian
Splatting for Real-Time Radiance Field Rendering"), with the conventions of
the system under test: EWA projection with a 0.3 px low-pass, the 3-sigma
radius of the larger eigenvalue, alpha = min(0.999, o * exp(power)) and 0
below 1/255, expected depth over accumulation with a 1e-3 floor, per-Gaussian
normals along the smallest scale axis facing the camera. A Gaussian reaches
the tiles of its radius box, at most the configuration's
max_tiles_per_gaussian of them: the isqrt x isqrt tiles from the box's
first tile (a departure from the paper, which the configuration states).
Every such pair is composited, with no per-tile budget, front to back by
exact camera depth; contributions behind a transmittance of 1e-4 are kept
(they are below it by construction).

Tiles are composited in chunks padded to the chunk's longest list, each
chunk under torch.utils.checkpoint, so a full view at its real size fits.

`control=True` rounds both operands of every matrix product to TF32 (10
mantissa bits, round to nearest, ties away from zero) and sums in float32,
which is what a float32 product on tensor cores does: the nearest precision
below the configuration's float32.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

ALPHA_MAX = 0.999
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
CHUNK_SLOTS = 1 << 17     # (tile, list slot) pairs per compositing chunk


def _round(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32(torch.autograd.Function):
    """Rounds a product's operand to TF32, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa (round to nearest, ties away)."""
    return _TF32.apply(x)


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, control: bool):
    """einsum of two operands, in TF32 under the control."""
    if control:
        a, b = tf32(a), tf32(b)
    return torch.einsum(eq, a, b)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def eval_sh(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Degree-3 real SH (N, 16, 3) at unit directions (N, 3) -> (N, 3)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = coeffs
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [SH_C0 + 0 * x, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * xz, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
             SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    out = 0
    for k, bk in enumerate(basis):
        out = out + bk * c[:, k, :]
    return out


def camera(cams: dict, v: int) -> dict:
    return dict(viewmat=cams["viewmat"][v], fx=cams["fx"][v],
                fy=cams["fy"][v], cx=cams["cx"][v], cy=cams["cy"][v],
                width=cams["width"], height=cams["height"])


def origin(cam: dict) -> torch.Tensor:
    R, t = cam["viewmat"][:3, :3], cam["viewmat"][:3, 3]
    return -(R.T @ t)


def project(means, quats, scales, cam: dict, raster: dict, control: bool):
    """EWA projection -> (mean2d (N, 2), depth (N,), conic (N, 3) as
    (a, b, c) of the inverse 2-D covariance, radius (N,), valid (N,))."""
    vm = cam["viewmat"]
    R, t = vm[:3, :3], vm[:3, 3]
    p = mm("nj,ij->ni", means, R, control) + t
    tz = p[:, 2]
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    M = mm("ij,njk->nik", R, quat_to_rotmat(quats), control)
    MS = M * (scales * scales)[:, None, :]
    cov = mm("nik,njk->nij", MS, M, control)
    fx, fy, W, H = cam["fx"], cam["fy"], cam["width"], cam["height"]
    lim_x, lim_y = 1.3 * (0.5 * W / fx), 1.3 * (0.5 * H / fy)
    txz = torch.clamp(p[:, 0] / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(p[:, 1] / tz_safe, -lim_y, lim_y)
    inv_z = 1.0 / tz_safe
    zero = torch.zeros_like(inv_z)
    J = torch.stack([torch.stack([fx * inv_z, zero, -fx * txz * inv_z], -1),
                     torch.stack([zero, fy * inv_z, -fy * tyz * inv_z], -1)],
                    -2)                                         # (N, 2, 3)
    JC = mm("nij,njk->nik", J, cov, control)
    V2 = mm("nik,njk->nij", JC, J, control)
    v00 = V2[:, 0, 0] + raster["eps2d"]
    v11 = V2[:, 1, 1] + raster["eps2d"]
    v01 = V2[:, 0, 1]
    det = v00 * v11 - v01 * v01
    inv_det = 1.0 / torch.clamp_min(det, 1e-10)
    conic = torch.stack([v11 * inv_det, -v01 * inv_det, v00 * inv_det], -1)
    mx = fx * p[:, 0] * inv_z + cam["cx"]
    my = fy * p[:, 1] * inv_z + cam["cy"]
    mid = 0.5 * (v00 + v11)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))
    valid = ((tz > raster["near"]) & (tz < raster["far"]) & (det > 0)
             & (radius > 0) & (mx + radius > 0) & (mx - radius < W)
             & (my + radius > 0) & (my - radius < H))
    return (torch.stack([mx, my], -1), tz, conic,
            torch.where(valid, radius, torch.zeros_like(radius)), valid)


def gaussian_normals(quats, scales, means, cam_origin):
    """Axis of the smallest scale, flipped to face the camera."""
    R = quat_to_rotmat(quats)
    k = torch.argmin(scales, dim=-1)
    n = torch.gather(R, 2, k[:, None, None].expand(-1, 3, 1))[..., 0]
    view = means - cam_origin
    flip = torch.sum(n * view, -1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def activate(params: dict, sh_band: int):
    """Rendered quantities of raw parameters: means, quats, scales,
    opacities, SH coefficients with the bands above `sh_band` zeroed. Rows
    flagged `frozen` pass no gradient to their geometry."""
    frozen = params.get("frozen")
    means, scales = params["means"], torch.exp(params["log_scales"])
    op = torch.sigmoid(params["logit_opacities"])
    if frozen is not None:
        means = torch.where(frozen[:, None], means.detach(), means)
        scales = torch.where(frozen[:, None], scales.detach(), scales)
        op = torch.where(frozen, op.detach(), op)
    coeffs = torch.cat([params["features_dc"][:, None, :],
                        params["features_rest"]], 1)
    band = torch.floor(torch.sqrt(torch.arange(
        coeffs.shape[1], dtype=torch.float32, device=coeffs.device)))
    coeffs = coeffs * (band <= sh_band).to(coeffs.dtype)[None, :, None]
    return means, params["quats"], scales, op, coeffs


def _pairs(mean2d, radius, depth, valid, ts: int, tiles_x: int,
           tiles_y: int, win: int):
    """Every (tile, Gaussian) pair of the radius boxes, each box cut to its
    first win x win tiles, sorted by tile and then by exact depth ->
    (tile (M,), gauss (M,))."""
    dev = mean2d.device
    ids = torch.nonzero(valid)[:, 0]
    m, r = mean2d[ids].detach(), radius[ids]

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi - 1).long()
    tx0, ty0 = tile_of(m[:, 0] - r, tiles_x), tile_of(m[:, 1] - r, tiles_y)
    bw = torch.clamp_max(tile_of(m[:, 0] + r, tiles_x) - tx0 + 1, win)
    bh = torch.clamp_max(tile_of(m[:, 1] + r, tiles_y) - ty0 + 1, win)
    cover = bw * bh
    g = torch.repeat_interleave(torch.arange(ids.shape[0], device=dev), cover)
    start = torch.cumsum(cover, 0) - cover
    j = torch.arange(g.shape[0], device=dev) - start[g]
    tile = (ty0[g] + j // bw[g]) * tiles_x + tx0[g] + j % bw[g]
    rank = torch.empty_like(ids)
    rank[torch.argsort(depth[ids].detach(), stable=True)] = torch.arange(
        ids.shape[0], device=dev)
    order = torch.argsort(tile * ids.shape[0] + rank[g], stable=True)
    return tile[order], ids[g[order]]


def _composite_chunk(pix, m2, cn, op, ch, control: bool):
    """pix (t, P, 2); per slot m2 (t, K, 2), cn (t, K, 3), op (t, K),
    ch (t, K, C) -> out (t, P, C), alpha (t, P), pairs (t,) evaluated
    before T < 1e-4."""
    dx = pix[:, :, None, 0] - m2[:, None, :, 0]
    dy = pix[:, :, None, 1] - m2[:, None, :, 1]
    power = (-0.5 * (cn[:, None, :, 0] * dx * dx + cn[:, None, :, 2] * dy * dy)
             - cn[:, None, :, 1] * dx * dy)
    alpha = torch.clamp_max(op[:, None, :] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    log_t = torch.log1p(-alpha)
    cum = torch.cumsum(log_t, -1)
    T = torch.exp(cum - log_t)
    out = mm("tpk,tkc->tpc", alpha * T, ch, control)
    pairs = torch.sum((alpha > 0) & (T >= T_MIN), dim=(1, 2))
    return out, 1.0 - torch.exp(cum[..., -1]), pairs


def render(params: dict, cam: dict, raster: dict, sh_band: int,
           control: bool = False, count: bool = False) -> dict:
    """One view of the Gaussians in `params` (rows = Gaussians; a row with
    `alive` False is left out) -> dict rgb (H, W, 3), depth (H, W),
    normal (H, W, 3), alpha (H, W), and with count=True `pairs`, the
    Gaussian-pixel pairs composited before the pixel's transmittance fell
    below 1e-4. Differentiable in params."""
    means, quats, scales, op, coeffs = activate(params, sh_band)
    alive = params.get("alive")
    if alive is not None:
        op = torch.where(alive, op, torch.zeros_like(op))
    mean2d, depth, conic, radius, valid = project(means, quats, scales, cam,
                                                  raster, control)
    if alive is not None:
        valid = valid & alive
    o = origin(cam)
    view = means - o
    view = view / (torch.linalg.norm(view, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(coeffs, view) + 0.5
    rgb = torch.maximum(rgb, torch.zeros_like(rgb))
    chan = torch.cat([rgb, depth[:, None],
                      gaussian_normals(quats, scales, means, o)], -1)
    W, H, ts = cam["width"], cam["height"], raster["tile_size"]
    tx, ty = -(-W // ts), -(-H // ts)
    T = tx * ty
    dev = means.device
    win = max(1, math.isqrt(raster["max_tiles_per_gaussian"]))
    tile, gid = _pairs(mean2d, radius, depth, valid, ts, tx, ty, win)
    counts = torch.bincount(tile, minlength=T)
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(ts, dtype=torch.float32, device=dev) + 0.5
    ly, lx = torch.meshgrid(local, local, indexing="ij")
    lxy = torch.stack([lx.reshape(-1), ly.reshape(-1)], -1)     # (P, 2)
    counts_h = counts.tolist()
    out_t = torch.zeros((T, ts * ts, chan.shape[1]), device=dev)
    alpha_t = torch.zeros((T, ts * ts), device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    busy = [i for i in range(T) if counts_h[i] > 0]
    i = 0
    outs, alphas, rows = [], [], []
    while i < len(busy):
        j, kmax = i, 0
        while j < len(busy) and max(kmax, counts_h[busy[j]]) * (j - i + 1) <= max(
                CHUNK_SLOTS, counts_h[busy[i]]):
            kmax = max(kmax, counts_h[busy[j]])
            j += 1
        sel = torch.tensor(busy[i:j], device=dev)
        slot = torch.arange(kmax, device=dev)
        pos = starts[sel][:, None] + slot[None, :]
        ok = slot[None, :] < counts[sel][:, None]
        g = gid[torch.clamp(pos, max=gid.shape[0] - 1)]
        g = torch.where(ok, g, torch.zeros_like(g))
        pix = (torch.stack([(sel % tx).float(), (sel // tx).float()], -1)
               * ts)[:, None, :] + lxy[None]
        args = (pix, mean2d[g], conic[g],
                torch.where(ok, op[g], torch.zeros_like(op[g])), chan[g])
        if torch.is_grad_enabled():
            o_c, a_c, p_c = checkpoint(_composite_chunk, *args, control,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            o_c, a_c, p_c = _composite_chunk(*args, control)
        outs.append(o_c)
        alphas.append(a_c)
        rows.append(sel)
        pairs = pairs + p_c.sum()
        i = j
    if rows:
        sel = torch.cat(rows)
        out_t = out_t.index_put((sel,), torch.cat(outs))
        alpha_t = alpha_t.index_put((sel,), torch.cat(alphas))
    img = (out_t.reshape(ty, tx, ts, ts, -1).permute(0, 2, 1, 3, 4)
           .reshape(ty * ts, tx * ts, -1))[:H, :W]
    acc = (alpha_t.reshape(ty, tx, ts, ts).permute(0, 2, 1, 3)
           .reshape(ty * ts, tx * ts))[:H, :W]
    d = torch.where(acc > 0, img[..., 3] / torch.clamp_min(acc, 1e-3),
                    torch.zeros_like(acc))
    res = dict(rgb=img[..., :3], depth=d, normal=img[..., 4:7], alpha=acc,
               normals_g=chan[:, 4:7])
    if count:
        res["pairs"] = int(pairs)
        res["visible"] = int(valid.sum())
    return res


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(-10.0 * torch.log10(torch.mean((a - b) ** 2) + 1e-10))


def mean_psnr(params: dict, cams: dict, images: torch.Tensor, raster: dict,
              sh_band: int) -> float:
    """Mean PSNR over every view of `params` rendered here against the GT."""
    with torch.no_grad():
        vals = [psnr(render(params, camera(cams, v), raster, sh_band)["rgb"],
                     images[v]) for v in range(images.shape[0])]
    return sum(vals) / len(vals)


def count_pairs(params: dict, cams: dict, raster: dict, sh_band: int,
                views) -> dict:
    """{view: (composited Gaussian-pixel pairs, projected Gaussians)}."""
    out = {}
    with torch.no_grad():
        for v in views:
            r = render(params, camera(cams, v), raster, sh_band, count=True)
            out[v] = (r["pairs"], r["visible"])
    return out
