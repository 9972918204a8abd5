"""The yardstick's arithmetic: the card's peaks and the work of compositing.

The work is what 3D Gaussian splatting's compositing evaluates, counted by
the reference renderer from the Gaussians' state (render.count_pairs): the
Gaussian-pixel pairs with alpha >= 1/255 that a pixel reaches before its
transmittance falls below 1e-4. Tiles, pair budgets, cover windows and the
kernels' culls do not enter it, so the count is the same whatever
implements the compositor.

Each pair costs 43 FP32 operations forward (the conic's quadratic form,
exp, the alpha clamps, log1p and the transmittance update, the blend of 7
channels) and 89 backward (the blend's and alpha's partials into the 2-D
mean, conic, opacity and the 7 channels, and the transmittance's suffix).
Bytes: each visible Gaussian's row (2-D mean, conic, log opacity, 7
channels: 13 floats) read once forward and once backward, its gradient row
written once; each pixel's 8 outputs (rgb, depth, normal, alpha) written
once forward, their cotangents and the outputs read once backward.
"""
from __future__ import annotations

PEAK_FP32 = 67e12       # H100 SXM: FP32 outside the tensor cores, FLOP/s
PEAK_HBM = 3.35e12      # H100 SXM: HBM3, bytes/s
FWD_OPS, BWD_OPS = 43, 89
ROW_FLOATS, PIXEL_FLOATS = 13, 8


def step_work(pairs: float, visible: float, pixels: int) -> tuple:
    """(FP32 operations, bytes) of one training step's compositing, forward
    and backward, for a view with `pairs` composited pairs and `visible`
    projected Gaussians."""
    ops = (FWD_OPS + BWD_OPS) * pairs
    row_bytes = 4 * ROW_FLOATS * visible
    pix_bytes = 4 * PIXEL_FLOATS * pixels
    return ops, (row_bytes + pix_bytes) + (2 * row_bytes + 2 * pix_bytes)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs for the work: its operations at the
    FP32 peak or its bytes at the HBM peak, whichever is longer."""
    return max(ops / PEAK_FP32, nbytes / PEAK_HBM)
