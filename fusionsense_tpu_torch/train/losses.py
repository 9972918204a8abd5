"""Loss primitives of the DN-Splatter objective.

Counterpart of fusionsense_tpu/train/losses.py: RGB L1 + SSIM, depth losses
incl. edge-aware log-L1, TV and edge-aware TV, normal L1 / cosine,
pseudo-normals from depth, flatness, opacity entropy and touch-normal
losses. Reductions are mask-weighted means.

`ssim` sends CPU tensors to the plain version (the separable window as two
banded matrix products, as the JAX package has it) and CUDA tensors to the
kernel pair of csrc/ssim.cu (train/ssim_kernels.py); there is no fallback
between the two. The gradient goes to the first image only.
"""
from __future__ import annotations

import functools

import torch

from fusionsense_tpu_torch.core.cameras import backproject_depth
from fusionsense_tpu_torch.train import ssim_kernels
from fusionsense_tpu_torch.utils.profiling import span


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * mask) / torch.clamp_min(torch.sum(mask), 1.0)


# ---------------------------------------------------------------- RGB ------

def gaussian_taps(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _band_matrix(n_out: int, n_in: int, taps: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) banded matrix B with B[i, i+j] = taps[j] (VALID conv)."""
    k = taps.shape[0]
    off = (torch.arange(n_in, device=taps.device)[None, :]
           - torch.arange(n_out, device=taps.device)[:, None])
    inband = (off >= 0) & (off < k)
    return torch.where(inband, taps[torch.clamp(off, 0, k - 1)],
                       torch.zeros((), device=taps.device))


def _filter2d_batch(imgs: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """Separable VALID filter over a (B, H, W) batch as two banded matrix
    products (float32; callers on the card keep TF32 off)."""
    _, H, W = imgs.shape
    k = k1.shape[0]
    Bv = _band_matrix(H - k + 1, H, k1)
    Bw = _band_matrix(W - k + 1, W, k1)
    t = torch.einsum("oh,bhw->bow", Bv, imgs)
    return torch.einsum("bow,pw->bop", t, Bw)


def ssim_plain(a: torch.Tensor, b: torch.Tensor, *, size: int = 11,
               sigma: float = 1.5, c1: float = 0.01 ** 2,
               c2: float = 0.03 ** 2) -> torch.Tensor:
    """The plain version: mean SSIM over an (H, W, C) pair in [0, 1], the
    window as banded matrix products under autograd."""
    ssim_kernels.LAUNCHES["ssim_plain"] += 1
    x = torch.movedim(a, -1, 0)
    y = torch.movedim(b, -1, 0)
    k1 = torch.tensor(_window(size, float(sigma)), device=a.device)
    f = _filter2d_batch(torch.cat([x, y, x * x, y * y, x * y], dim=0), k1)
    C = x.shape[0]
    mu_a, mu_b = f[:C], f[C:2 * C]
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = f[2 * C:3 * C] - mu_aa
    sig_b = f[3 * C:4 * C] - mu_bb
    sig_ab = f[4 * C:] - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sig_ab + c2)) / (
        (mu_aa + mu_bb + c1) * (sig_a + sig_b + c2))
    return torch.mean(s)


def ssim(a: torch.Tensor, b: torch.Tensor, *, size: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair in [0, 1]: the kernel pair for CUDA
    tensors, the plain version for CPU ones."""
    if a.device != b.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    with span("fs.ssim"):
        if a.device.type == "cuda":
            return ssim_kernels.ssim_cuda(a, b, _window(size, float(sigma)),
                                          c1, c2)
        return ssim_plain(a, b, size=size, sigma=sigma, c1=c1, c2=c2)


@functools.lru_cache(maxsize=None)
def _window(size: int, sigma: float) -> tuple:
    """SSIM's 1-D window as host floats, computed once in float32 on the
    CPU for every device: column 0 of the 2-D window, normalised, as the
    reference takes it. One window for both routes: its float32 sum is not
    exactly 1, and sigma = E[x^2] - mu^2 turns a window an ulp off into a
    gap of ~1e-5 in the mean."""
    g = gaussian_taps(size, sigma)
    k1 = g * g[0]
    return tuple(float(v) for v in k1 / torch.sum(k1))


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor,
             mask: torch.Tensor | None = None,
             ssim_lambda: float = 0.2) -> torch.Tensor:
    """(1 - lambda) * L1 + lambda * (1 - SSIM), the splatfacto main loss."""
    if mask is not None:
        pred = pred * mask
        gt = gt * mask
    l1 = torch.mean(torch.abs(pred - gt))
    return (1 - ssim_lambda) * l1 + ssim_lambda * (1.0 - ssim(pred, gt))


# -------------------------------------------------------------- depth ------

def depth_l1(pred, gt, mask=None):
    return _masked_mean(torch.abs(pred - gt), mask)


def depth_mse(pred, gt, mask=None):
    return _masked_mean((pred - gt) ** 2, mask)


def depth_logl1(pred, gt, mask=None):
    return _masked_mean(torch.log1p(torch.abs(pred - gt)), mask)


def depth_huberl1(pred, gt, mask=None, delta: float = 0.2):
    err = torch.abs(pred - gt)
    loss = torch.where(err < delta, 0.5 * err * err / delta, err - 0.5 * delta)
    return _masked_mean(loss, mask)


def edge_weight(rgb: torch.Tensor):
    """exp(-mean|grad rgb|) along x and y; shapes (H, W-1), (H-1, W)."""
    gx = torch.mean(torch.abs(rgb[:, 1:] - rgb[:, :-1]), dim=-1)
    gy = torch.mean(torch.abs(rgb[1:, :] - rgb[:-1, :]), dim=-1)
    return torch.exp(-gx), torch.exp(-gy)


def _pair_masks(mask):
    if mask is None:
        return None, None
    return mask[:, 1:] * mask[:, :-1], mask[1:, :] * mask[:-1, :]


def depth_edge_aware_logl1(pred, gt, rgb, mask=None):
    """Log-L1 weighted by image-gradient edge awareness."""
    logl1 = torch.log1p(torch.abs(pred - gt))
    wx, wy = edge_weight(rgb)
    mx, my = _pair_masks(mask)
    return 0.5 * (_masked_mean(logl1[:, 1:] * wx, mx)
                  + _masked_mean(logl1[1:, :] * wy, my))


def _grads(img):
    gx = torch.abs(img[:, 1:] - img[:, :-1])
    gy = torch.abs(img[1:, :] - img[:-1, :])
    if img.ndim == 3:
        gx, gy = torch.mean(gx, -1), torch.mean(gy, -1)
    return gx, gy


def tv_loss(img: torch.Tensor, mask=None) -> torch.Tensor:
    """Total variation over (H, W) or (H, W, C)."""
    gx, gy = _grads(img)
    mx, my = _pair_masks(mask)
    return _masked_mean(gx, mx) + _masked_mean(gy, my)


def edge_aware_tv(img: torch.Tensor, rgb: torch.Tensor, mask=None) -> torch.Tensor:
    gx, gy = _grads(img)
    wx, wy = edge_weight(rgb)
    mx, my = _pair_masks(mask)
    return _masked_mean(gx * wx, mx) + _masked_mean(gy * wy, my)


DEPTH_LOSSES = {
    "MSE": depth_mse,
    "L1": depth_l1,
    "LogL1": depth_logl1,
    "HuberL1": depth_huberl1,
}


# ------------------------------------------------------------- normal ------

def normal_l1(pred: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    return _masked_mean(torch.mean(torch.abs(pred - gt), dim=-1), mask)


def normal_cosine(pred: torch.Tensor, gt: torch.Tensor, mask=None,
                  eps=1e-8) -> torch.Tensor:
    pn = pred / (torch.linalg.norm(pred, dim=-1, keepdim=True) + eps)
    gn = gt / (torch.linalg.norm(gt, dim=-1, keepdim=True) + eps)
    return _masked_mean(1.0 - torch.sum(pn * gn, dim=-1), mask)


def normals_from_depth(depth: torch.Tensor, camera) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-facing pseudo-normals from cross
    products of backprojected neighbour differences (edge-padded)."""
    H, W = depth.shape
    pts = backproject_depth(depth, camera).reshape(H, W, 3)
    dx = pts[:, 2:, :] - pts[:, :-2, :]
    dy = pts[2:, :, :] - pts[:-2, :, :]
    dx = torch.cat([dx[:, :1], dx, dx[:, -1:]], dim=1)
    dy = torch.cat([dy[:1], dy, dy[-1:]], dim=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-8)
    view = camera.origin - pts
    flip = torch.sum(n * view, dim=-1, keepdim=True) < 0
    return torch.where(flip, -n, n)


# ------------------------------------------------------- regularizers ------

def flatness_loss(log_scales: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Mean over alive of min(exp(scales)): encourages flat discs. amin
    shares the gradient among tied axes (an isotropic init), as jnp.min
    does."""
    min_scale = torch.amin(torch.exp(log_scales), dim=-1)
    return (torch.sum(torch.where(alive, min_scale, torch.zeros_like(min_scale)))
            / torch.clamp_min(torch.sum(alive), 1))


def opacity_entropy_loss(logit_opacities: torch.Tensor,
                         alive: torch.Tensor) -> torch.Tensor:
    """Sparse-opacity binary entropy over alive slots."""
    o = torch.clamp(torch.sigmoid(logit_opacities), 1e-6, 1 - 1e-6)
    ent = -(o * torch.log(o) + (1 - o) * torch.log(1 - o))
    return (torch.sum(torch.where(alive, ent, torch.zeros_like(ent)))
            / torch.clamp_min(torch.sum(alive), 1))


def touch_normal_loss(normals: torch.Tensor, target_normals: torch.Tensor,
                      frozen: torch.Tensor) -> torch.Tensor:
    """MSE between Gaussian normals and tactile normals on anchored slots."""
    err = torch.sum((normals - target_normals) ** 2, dim=-1)
    return (torch.sum(torch.where(frozen, err, torch.zeros_like(err)))
            / torch.clamp_min(torch.sum(frozen), 1))
