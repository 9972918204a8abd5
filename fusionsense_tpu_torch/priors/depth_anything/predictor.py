"""Depth-Anything predictor implementing the DepthModel protocol.

Counterpart of fusionsense_tpu/priors/depth_anything/predictor.py. Input
contract (Depth-Anything-V2 `image2tensor`): resize keeping the aspect so
the SHORT side is >= 518 with both sides multiples of 14 (jax.image.resize
cubic, priors/resize.py), ImageNet normalisation; the relative inverse
depth comes back to the source resolution (jax.image.resize linear, which
low-passes on the way down).

`predict_depth` returns METRIC depth when sensor depth is given: the
inverse is inverted and scale/shift-aligned per frame by the closed-form
least squares the reference uses for its mono-depth artifacts
(depth_from_pretrain.py depth_align / align_depth.py
compute_scale_and_shift). The net runs on the predictor's device, in eval
mode, under torch.inference_mode, with TF32 off (priors/tf32.py), its
input and output resizes too.
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.priors.depth_anything.dpt import (
    DAConfig, DepthAnything,
)
from fusionsense_tpu_torch.priors.resize import resize
from fusionsense_tpu_torch.priors.tf32 import full_float32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def da_input_size(h: int, w: int, lower: int = 518, patch: int = 14):
    """(h', w') — short side >= lower, aspect kept, both multiples of 14."""
    s = max(lower / h, lower / w)
    rh, rw = max(int(round(h * s)), lower), max(int(round(w * s)), lower)
    rh += (-rh) % patch
    rw += (-rw) % patch
    return rh, rw


class DepthAnythingModel:
    """DepthModel: rgb (H, W, 3) -> (H, W) depth (aligned when possible)."""

    def __init__(self, net: DepthAnything, lower: int = 518, device=None):
        from fusionsense_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.lower = lower

    @classmethod
    def from_checkpoint(cls, path: str, cfg: DAConfig = DAConfig(),
                        device=None):
        from fusionsense_tpu_torch.priors.depth_anything.convert import (
            load_da_checkpoint,
        )

        return cls(load_da_checkpoint(path, cfg), device=device)

    def _inverse(self, rgb: np.ndarray) -> torch.Tensor:
        h, w = rgb.shape[:2]
        rh, rw = da_input_size(h, w, self.lower, self.cfg.vit.patch)
        x = np.asarray(rgb, np.float32)
        if x.max() > 2.0:
            x = x / 255.0
        # the resizes are matmuls too: inside the float32 context
        with torch.inference_mode(), full_float32():
            x = resize(torch.from_numpy(x).to(self.device), (rh, rw, 3),
                       "bicubic")
            mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
            std = torch.from_numpy(IMAGENET_STD).to(self.device)
            x = ((x - mean) / std).permute(2, 0, 1)[None]
            return resize(self.net(x)[0], (h, w), "bilinear")

    def predict_inverse(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W) relative inverse depth at source resolution."""
        return self._inverse(rgb).cpu().numpy()

    def predict_depth(self, rgb: np.ndarray, fx: float,
                      sensor_depth: np.ndarray | None = None) -> np.ndarray:
        from fusionsense_tpu_torch.priors.depth_align import (
            scale_and_shift_lstsq,
        )

        depth = 1.0 / torch.clamp_min(self._inverse(rgb), 1e-4)
        if sensor_depth is not None:
            sensor = torch.as_tensor(np.asarray(sensor_depth, np.float32),
                                     device=self.device)
            s, t = scale_and_shift_lstsq(depth, sensor, sensor > 1e-6)
            depth = s * depth + t
        return depth.cpu().numpy().astype(np.float32)
