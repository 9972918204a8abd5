"""SSIM on the card: the kernel pair of csrc/ssim.cu behind one autograd
Function.

train/losses.py `ssim` sends CUDA tensors here with the window it computes
for both routes (`losses._window`); CPU tensors take its plain version.
The forward is one kernel (the five filtered moments, the SSIM map's
partial sums and, when a gradient is wanted, three derivative maps) with
a one-CTA launch for the mean; the backward is one kernel (the transposed
window over the maps). The gradient goes to the first image only; the
wrappers refuse what the kernels cannot take, and nothing falls back to
the plain version.
"""
from __future__ import annotations

import torch

from fusionsense_tpu_torch.kernels.build import Launches, check, launch

# launch counts (kernels/build.py Launches): a forward or backward call
# counts once; ssim_plain counts train/losses.py's plain version
_COUNTS = Launches(("ssim_fwd", "ssim_bwd"), plain=("ssim_plain",))
LAUNCHES, CAPTURED = _COUNTS.counts, _COUNTS.captured
reset_launch_counts, _count = _COUNTS.reset, _COUNTS.count

_FNS = {   # C entry point -> (pointer, int, float arguments)
    "fs_ssim_fwd": (5, 3, 13), "fs_ssim_bwd": (5, 3, 13),
}
TAPS = 11
_TILE = 32            # a CTA's output tile, as in csrc/ssim.cu
_F32 = torch.float32


def _check(*specs):
    """Each spec (name, tensor, shape) must be a contiguous float32 tensor
    of that shape on the first one's device, a CUDA device."""
    check(specs[0][1].device,
          *((name, t, _F32, shape) for name, t, shape in specs))


def _image_shape(a: torch.Tensor) -> tuple:
    if a.ndim != 3:
        raise ValueError(f"a must be an (H, W, C) image, got {tuple(a.shape)}")
    H, W, C = a.shape
    if H < TAPS or W < TAPS or C < 1:
        raise ValueError(f"the SSIM window needs H, W >= {TAPS} and C >= 1, "
                         f"got {tuple(a.shape)}")
    if 3 * H * W * C >= 2 ** 31:
        raise ValueError(f"image {tuple(a.shape)} too large for the kernels")
    return H, W, C


def maps_shape(H: int, W: int, C: int) -> tuple:
    return (3, C, H - TAPS + 1, W - TAPS + 1)


def _launch(fn, tensors, ints, floats):
    launch("ssim", _FNS, fn, tensors, ints, floats)


def ssim_fwd_cuda(a, b, floats, maps: bool):
    """The forward kernel: (mean SSIM, the derivative maps or None).
    floats are the window's taps, c1 and c2."""
    H, W, C = _image_shape(a)
    _check(("a", a, (H, W, C)), ("b", b, (H, W, C)))
    Ho, Wo = H - TAPS + 1, W - TAPS + 1
    blocks = -(-Ho // _TILE) * -(-Wo // _TILE) * C
    loss = torch.empty((), dtype=_F32, device=a.device)
    part = torch.empty((blocks,), dtype=torch.float64, device=a.device)
    m = (torch.empty(maps_shape(H, W, C), dtype=_F32, device=a.device)
         if maps else None)
    _launch("fs_ssim_fwd", (a, b, loss, part, m), (H, W, C), floats)
    _count("ssim_fwd")
    return loss, m


def ssim_bwd_cuda(a, b, maps, g, floats):
    """The backward kernel: d (g * mean SSIM) / d a from the forward's
    maps and the cotangent g (one element, read on the device)."""
    H, W, C = _image_shape(a)
    _check(("a", a, (H, W, C)), ("b", b, (H, W, C)),
           ("maps", maps, maps_shape(H, W, C)), ("g", g, ()))
    da = torch.empty((H, W, C), dtype=_F32, device=a.device)
    _launch("fs_ssim_bwd", (a, b, maps, g, da), (H, W, C), floats)
    _count("ssim_bwd")
    return da


class _SSIM(torch.autograd.Function):
    """The mean SSIM of (a, b), with the gradient of a."""

    @staticmethod
    def forward(ctx, a, b, floats):
        a, b = a.contiguous(), b.contiguous()
        loss, maps = ssim_fwd_cuda(a, b, floats, maps=True)
        ctx.save_for_backward(a, b, maps)
        ctx.floats = floats
        return loss

    @staticmethod
    def backward(ctx, g):
        a, b, maps = ctx.saved_tensors
        da = ssim_bwd_cuda(a, b, maps, g.contiguous(), ctx.floats)
        return da, None, None


def ssim_cuda(a: torch.Tensor, b: torch.Tensor, window: tuple, c1: float,
              c2: float) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) pair through the kernel pair (_SSIM),
    `window` the 1-D window's taps as host floats; the forward alone,
    writing no maps, where no gradient is wanted."""
    if len(window) != TAPS:
        raise ValueError(f"the SSIM kernels take an {TAPS}-tap window, "
                         f"got {len(window)}")
    grad = torch.is_grad_enabled()
    if grad and b.requires_grad:
        raise ValueError("the SSIM kernels give no gradient of b")
    floats = (*window, float(c1), float(c2))
    if grad and a.requires_grad:
        return _SSIM.apply(a, b, floats)
    return ssim_fwd_cuda(a.contiguous(), b.contiguous(), floats, maps=False)[0]
