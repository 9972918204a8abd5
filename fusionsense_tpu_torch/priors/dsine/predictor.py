"""DSINE predictor implementing the NormalModel protocol.

Counterpart of fusionsense_tpu/priors/dsine/predictor.py (the reference's
dsine_predictor.py): zero-pad to /32 (centred), ImageNet normalisation,
FOV-60 intrinsics when none are given (:31-49), the principal point moved
by the padding, crop back. Returns camera-space normals (H, W, 3) in
DSINE's convention. The net runs on the predictor's device, in eval mode,
under torch.inference_mode, with TF32 off (priors/tf32.py).
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.priors.dsine.model import DSINE, DSINEConfig
from fusionsense_tpu_torch.priors.tf32 import full_float32

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pad_to_32(h: int, w: int) -> tuple[int, int, int, int]:
    """(left, right, top, bottom) centered zero-padding to /32."""
    pw = (-w) % 32
    ph = (-h) % 32
    return pw // 2, pw - pw // 2, ph // 2, ph - ph // 2


def fov_intrinsics(h: int, w: int, fov_deg: float = 60.0) -> np.ndarray:
    f = (max(h, w) / 2.0) / np.tan(np.deg2rad(fov_deg / 2.0))
    return np.array([[f, 0, w / 2.0 - 0.5],
                     [0, f, h / 2.0 - 0.5],
                     [0, 0, 1]], np.float32)


class DSinePredictor:
    """NormalModel: rgb (H, W, 3) uint8/float -> (H, W, 3) normals."""

    def __init__(self, net: DSINE, device=None):
        from fusionsense_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg

    @classmethod
    def from_checkpoint(cls, path: str, cfg: DSINEConfig = DSINEConfig(),
                        device=None):
        from fusionsense_tpu_torch.priors.dsine.convert import (
            load_dsine_checkpoint,
        )

        return cls(load_dsine_checkpoint(path, cfg), device)

    def predict_normals(self, rgb: np.ndarray,
                        K: np.ndarray | None = None) -> np.ndarray:
        img = np.asarray(rgb, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        h, w = img.shape[:2]
        left, right, top, bottom = pad_to_32(h, w)
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        img = np.pad(img, ((top, bottom), (left, right), (0, 0)))
        if K is None:
            K = fov_intrinsics(h, w)
        K = np.asarray(K, np.float32).copy()
        K[0, 2] += left
        K[1, 2] += top
        x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
        with torch.inference_mode(), full_float32():
            out = self.net(x[None].to(self.device),
                           torch.from_numpy(K)[None].to(self.device))
        out = out[0].permute(1, 2, 0).cpu().numpy()
        return out[top:top + h, left:left + w]
