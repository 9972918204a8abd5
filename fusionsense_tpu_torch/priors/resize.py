"""Image resampling with jax.image.resize's semantics, for the prior nets.

The JAX package's nets resize with jax.image.resize (the pos-embed grid and
the inputs of Depth-Anything, DSINE's decoder). Its "linear" and "cubic"
methods are not F.interpolate's:
- "cubic" is the Keys kernel with a = -0.5 (F.interpolate's bicubic uses
  -0.75);
- at the borders the kernel weights are renormalised over the taps that
  fall inside the image, where F.interpolate clamps indices;
- on a downscale the kernel is stretched by the scale, a low-pass filter
  (antialias=True, the default every caller keeps), where F.interpolate
  samples.
Each resampled axis is a dense (in, out) weight matrix, made as
jax.image's compute_weight_mat makes it, and applied as one matmul.
"""
from __future__ import annotations

import functools

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(x), out)


KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """(n_in, n_out) resampling weights of one axis, no translation. Built
    outside inference mode, so the cached matrix also serves a forward that
    records a graph."""
    kernel = KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    with torch.inference_mode(False):
        sample_f = ((torch.arange(n_out, dtype=dtype, device=device) + 0.5)
                    * inv_scale - 0.0 * inv_scale - 0.5)
        x = torch.abs(sample_f[None, :] - torch.arange(
            n_in, dtype=dtype, device=device)[:, None]) / kernel_scale
        w = kernel(x)
        total = torch.sum(w, dim=0, keepdim=True)
        w = torch.where(torch.abs(total) > 1000. * _EPS32,
                        w / torch.where(total != 0, total,
                                        torch.ones_like(total)),
                        torch.zeros_like(w))
        inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
        return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """jax.image.resize(x, shape, method) for method "bilinear" or
    "bicubic": every axis whose size changes is resampled, on x's device and
    in its dtype."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} does not match x's {tuple(x.shape)}")
    if method not in KERNELS:
        raise ValueError(f"unsupported resize method {method!r}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = weight_matrix(n_in, n_out, method, x.dtype, x.device)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
