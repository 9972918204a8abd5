"""Brute-force reference rasterizer: every pixel composites every Gaussian.

Counterpart of fusionsense_tpu/render/naive.py. O(H*W*N): a test oracle
only; the tiled backends must match it up to tile-capacity truncation.
"""
from __future__ import annotations

import torch

from fusionsense_tpu_torch.core.cameras import Camera, pixel_centers
from fusionsense_tpu_torch.core.sh import eval_sh
from fusionsense_tpu_torch.core.transforms import normalize
from fusionsense_tpu_torch.device import check_on, resolve_device
from fusionsense_tpu_torch.render.composite import ALPHA_MAX, ALPHA_MIN
from fusionsense_tpu_torch.render.project import project_gaussians
from fusionsense_tpu_torch.render.rasterize import (
    RasterizeConfig, expected_depth, gaussian_flat_normals,
)


def rasterize_naive(means, quats, scales, opacities, colors, camera: Camera,
                    cfg: RasterizeConfig = RasterizeConfig(), *, normals=None,
                    background=None, device=None) -> dict:
    """Render one camera on `device` (the card by default) -> dict of rgb,
    depth, normal, alpha."""
    dev = resolve_device(device)
    check_on(dev, means=means, quats=quats, scales=scales,
             opacities=opacities, colors=colors, viewmat=camera.viewmat)
    proj = project_gaussians(means, quats, scales, opacities, camera,
                             near=cfg.near, far=cfg.far, eps2d=cfg.eps2d,
                             antialiased=cfg.antialiased,
                             radius_clip=cfg.radius_clip)
    order = torch.argsort(torch.where(proj.valid, proj.depth,
                                      torch.full_like(proj.depth, float("inf"))),
                          stable=True)
    cam_origin = camera.origin
    if colors.ndim == 3:
        viewdir = normalize(means - cam_origin)
        rgb_g = torch.clamp_min(eval_sh(colors, viewdir, cfg.sh_degree) + 0.5,
                                0.0)
    else:
        rgb_g = colors
    if normals is None:
        normals = gaussian_flat_normals(quats, scales, means, cam_origin)
    channels = torch.cat([rgb_g, proj.depth[:, None], normals], -1)
    op = opacities * proj.compensation if cfg.antialiased else opacities

    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    op = torch.where(proj.valid[order], op[order], torch.zeros_like(op))
    chan = channels[order]

    pix = pixel_centers(camera.width, camera.height, dev).reshape(-1, 2)
    d = pix[:, None, :] - mean2d[None, :, :]                       # (P, N, 2)
    power = (-0.5 * (conic[None, :, 0] * d[..., 0] ** 2
                     + conic[None, :, 2] * d[..., 1] ** 2)
             - conic[None, :, 1] * d[..., 0] * d[..., 1])
    alpha = torch.clamp_max(op[None, :] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where(alpha < ALPHA_MIN, torch.zeros_like(alpha), alpha)
    log_t = torch.log1p(-alpha)
    cum = torch.cumsum(log_t, dim=-1)
    w = alpha * torch.exp(cum - log_t)                             # (P, N)
    out = w @ chan                                                 # (P, C)
    acc = 1.0 - torch.exp(cum[:, -1])

    H, W = camera.height, camera.width
    img = out.reshape(H, W, -1)
    alpha_map = acc.reshape(H, W)
    rgb = img[..., :3]
    if background is not None:
        rgb = rgb + (1.0 - alpha_map)[..., None] * background
    return dict(rgb=rgb, depth=expected_depth(img[..., 3], alpha_map),
                normal=img[..., 4:7], alpha=alpha_map)
