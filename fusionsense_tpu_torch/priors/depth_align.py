"""Monocular-depth alignment: scale/shift fitting against sparse metric
depth.

Counterpart of fusionsense_tpu/priors/depth_align.py (the reference's
align_depth.py:188 compute_scale_and_shift, metric3dv2_depth_generation.py
:17-51 compute_scale_and_offset, and align_depth.py's SGD stage):
- the closed-form per-image scale+shift least squares, batched over
  leading axes,
- a Huber-robust gradient refinement of (s, t) from that start, with the
  gradient written out (the loss's jax.grad in the JAX package).
Tensors stay on their device.
"""
from __future__ import annotations

import torch

HUBER_DELTA = 0.1


def scale_and_shift_lstsq(mono: torch.Tensor, metric: torch.Tensor,
                          mask: torch.Tensor):
    """Closed-form (s, t) minimizing ||s*mono + t - metric||^2 over mask.

    Shapes: (..., H, W); returns (...,) scale and shift."""
    m = mask.to(torch.float32)
    dims = (-2, -1)
    n = torch.clamp_min(torch.sum(m, dim=dims), 1.0)
    sum_x = torch.sum(mono * m, dim=dims)
    sum_y = torch.sum(metric * m, dim=dims)
    sum_xx = torch.sum(mono * mono * m, dim=dims)
    sum_xy = torch.sum(mono * metric * m, dim=dims)
    det = n * sum_xx - sum_x * sum_x
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    s = (n * sum_xy - sum_x * sum_y) / det
    t = (sum_xx * sum_y - sum_x * sum_xy) / det
    return s, t


def align_depth_gd(mono: torch.Tensor, metric: torch.Tensor,
                   mask: torch.Tensor, iters: int = 200, lr: float = 0.1):
    """Huber-robust gradient refinement of (s, t) from the lstsq start, on
    one (H, W) image. Returns the aligned depth s*mono + t and (s, t).

    The loss is sum(huber(err)) / n with err = (s*mono + t - metric) * mask
    and huber(a) = a^2 / (2 delta) below delta, a - delta / 2 above it; its
    derivative in err is err / delta below delta and sign(err) above."""
    s, t = scale_and_shift_lstsq(mono, metric, mask)
    m = mask.to(torch.float32)
    n = torch.clamp_min(torch.sum(m), 1.0)
    mono_m = mono * m
    for _ in range(iters):
        err = (s * mono + t - metric) * m
        dh = torch.where(torch.abs(err) < HUBER_DELTA, err / HUBER_DELTA,
                         torch.sign(err))
        g_s = torch.sum(dh * mono_m) / n
        g_t = torch.sum(dh * m) / n
        s, t = s - lr * g_s, t - lr * g_t
    return s * mono + t, (s, t)


def align_mono_depths(mono_depths, metric_depths, tolerance: float = 0.1,
                      iters: int = 200, device=None):
    """Batched alignment: (V, H, W) mono depths onto sparse/sensor metric
    depth (invalid where <= tolerance), on `device` (the card by default).
    Returns the aligned (V, H, W) tensor."""
    from fusionsense_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    mono = torch.as_tensor(mono_depths, dtype=torch.float32, device=dev)
    metric = torch.as_tensor(metric_depths, dtype=torch.float32, device=dev)
    mask = metric > tolerance
    return torch.stack([align_depth_gd(mono[i], metric[i], mask[i],
                                       iters=iters)[0]
                        for i in range(mono.shape[0])])
