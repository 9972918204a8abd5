"""The DN-Splatter objective in plain torch (Turkulainen et al. 2024,
"DN-Splatter: Depth and Normal Priors for Gaussian Splatting and Meshing"),
with the weights of a configuration's `loss` group.

RGB: (1 - l) L1 + l (1 - SSIM), SSIM with an 11-tap Gaussian window
(sigma 1.5, VALID); depth: edge-aware log-L1 on pixels whose depth is past
`depth_tolerance`; smoothness: edge-aware TV of the depth; normals: L1 to
the prior plus TV of the rendered normals; flatness: mean smallest scale;
touch: squared error of the Gaussian normals to the anchored normals.
"""
from __future__ import annotations

import torch

from fsbench.reference.render import mm


def _masked_mean(x, mask):
    if mask is None:
        return torch.mean(x)
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _band(n_out: int, n_in: int, taps: torch.Tensor) -> torch.Tensor:
    k = taps.shape[0]
    off = (torch.arange(n_in, device=taps.device)[None, :]
           - torch.arange(n_out, device=taps.device)[:, None])
    return torch.where((off >= 0) & (off < k),
                       taps[torch.clamp(off, 0, k - 1)],
                       torch.zeros((), device=taps.device))


def ssim(a, b, control: bool, size: int = 11, sigma: float = 1.5,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """Mean SSIM of two (H, W, C) images, the separable window applied as
    two banded matrix products."""
    x, y = torch.movedim(a, -1, 0), torch.movedim(b, -1, 0)
    t = torch.arange(size, dtype=torch.float32, device=a.device) - (size - 1) / 2
    g = torch.exp(-(t ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    k1 = g * g[0]
    k1 = k1 / torch.sum(k1)
    stack = torch.cat([x, y, x * x, y * y, x * y], 0)
    _, H, W = stack.shape
    f = mm("oh,bhw->bow", _band(H - size + 1, H, k1), stack, control)
    f = mm("bow,pw->bop", f, _band(W - size + 1, W, k1), control)
    C = x.shape[0]
    mu_a, mu_b = f[:C], f[C:2 * C]
    sig_a = f[2 * C:3 * C] - mu_a * mu_a
    sig_b = f[3 * C:4 * C] - mu_b * mu_b
    sig_ab = f[4 * C:] - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sig_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (sig_a + sig_b + c2))
    return torch.mean(s)


def _edges(rgb):
    gx = torch.mean(torch.abs(rgb[:, 1:] - rgb[:, :-1]), -1)
    gy = torch.mean(torch.abs(rgb[1:, :] - rgb[:-1, :]), -1)
    return torch.exp(-gx), torch.exp(-gy)


def _grads(img):
    gx = torch.abs(img[:, 1:] - img[:, :-1])
    gy = torch.abs(img[1:, :] - img[:-1, :])
    if img.ndim == 3:
        gx, gy = torch.mean(gx, -1), torch.mean(gy, -1)
    return gx, gy


def depth_term(pred, gt, rgb_floor, tolerance):
    valid = (gt > tolerance).to(torch.float32)
    logl1 = torch.log1p(torch.abs(pred - gt))
    wx, wy = _edges(rgb_floor)
    return 0.5 * (_masked_mean(logl1[:, 1:] * wx, valid[:, 1:] * valid[:, :-1])
                  + _masked_mean(logl1[1:, :] * wy, valid[1:, :] * valid[:-1, :]))


def objective(out: dict, params: dict, view: dict, loss: dict,
              control: bool) -> torch.Tensor:
    """The total loss of one rendered view. `view` holds image, depth (the
    sensor depth), mono_depth and normal (the normal prior) of the view;
    `params` the raw parameters (log_scales, normals, frozen)."""
    gt = view["image"]
    l1 = torch.mean(torch.abs(out["rgb"] - gt))
    lam = loss["ssim_lambda"]
    total = (1 - lam) * l1 + lam * (1.0 - ssim(out["rgb"], gt, control))
    floor = torch.clamp_min(gt, 10.0 / 255.0)
    if loss["sensor_depth_lambda"] > 0:
        total = total + loss["sensor_depth_lambda"] * depth_term(
            out["depth"], view["depth"], floor, loss["depth_tolerance"])
    if loss["mono_depth_lambda"] > 0:
        total = total + loss["mono_depth_lambda"] * depth_term(
            out["depth"], view["mono_depth"], floor, loss["depth_tolerance"])
    if loss["smooth_lambda"] > 0:
        gx, gy = _grads(out["depth"])
        wx, wy = _edges(floor)
        total = total + loss["smooth_lambda"] * (torch.mean(gx * wx)
                                                 + torch.mean(gy * wy))
    if loss["normal_lambda"] > 0:
        nl = torch.mean(torch.mean(torch.abs(out["normal"] - view["normal"]),
                                   -1))
        gx, gy = _grads(out["normal"])
        total = total + loss["normal_lambda"] * (nl + torch.mean(gx)
                                                 + torch.mean(gy))
    alive = params.get("alive")
    n_alive = (params["log_scales"].shape[0] if alive is None
               else torch.clamp_min(torch.sum(alive), 1))
    if loss["flatness_lambda"] > 0:
        smin = torch.amin(torch.exp(params["log_scales"]), -1)
        if alive is not None:
            smin = torch.where(alive, smin, torch.zeros_like(smin))
        total = total + loss["flatness_lambda"] * torch.sum(smin) / n_alive
    frozen = params.get("frozen")
    if loss["touch_normal_lambda"] > 0 and frozen is not None:
        err = torch.sum((out["normals_g"] - params["normals"]) ** 2, -1)
        total = total + loss["touch_normal_lambda"] * (
            torch.sum(torch.where(frozen, err, torch.zeros_like(err)))
            / torch.clamp_min(torch.sum(frozen), 1))
    return total
