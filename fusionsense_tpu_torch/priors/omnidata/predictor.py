"""Omnidata normal provider: the reference's `--model-type omnidata` (low
and hd resolutions) as a NormalModel.

Counterpart of fusionsense_tpu/priors/omnidata/predictor.py (reference
dn_splatter/scripts/normals_from_pretrain.py:60-101, 149-283):
- low: the frame resized to 384x384 (jax.image.resize's bilinear, which
  low-passes on the way down, priors/resize.py), one forward, the [0, 1]
  encoding decoded to unit normals, resized back and renormalised;
- hd (frames larger than 384 on both sides): the overlapped 384x384 crops
  of hd_merge.crop_grid through the net in one batch on the device, then
  merged on the host by hd_merge.merge_patches (float64 numpy, SVD
  alignment).
The net runs on the predictor's device, in eval mode, under
torch.inference_mode, with TF32 off (priors/tf32.py), its resizes too.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from fusionsense_tpu_torch.priors.omnidata.dpt_hybrid import (
    OmniConfig, OmnidataNormals,
)
from fusionsense_tpu_torch.priors.omnidata.hd_merge import (
    IMAGE_SIZE, crop_grid, merge_patches,
)
from fusionsense_tpu_torch.priors.resize import resize
from fusionsense_tpu_torch.priors.tf32 import full_float32


def _unit(n: torch.Tensor, dim: int) -> torch.Tensor:
    return n / (torch.linalg.norm(n, dim=dim, keepdim=True) + 1e-15)


class OmnidataPredictor:
    """NormalModel: rgb (H, W, 3) uint8/float -> (H, W, 3) camera-space
    normals in [-1, 1]."""

    def __init__(self, net: OmnidataNormals,
                 resolution: Literal["low", "hd"] = "low", device=None):
        from fusionsense_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.resolution = resolution

    @classmethod
    def from_checkpoint(cls, path: str, cfg: OmniConfig = OmniConfig(),
                        resolution: Literal["low", "hd"] = "low",
                        device=None):
        from fusionsense_tpu_torch.priors.omnidata.convert import (
            load_omnidata_checkpoint,
        )

        net, _ = load_omnidata_checkpoint(path, cfg)
        return cls(net, resolution, device)

    def _run_patches(self, rgb01: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) [0, 1] on the device -> (N, 3, S, S) unit normals
        in [-1, 1] (the reference decodes the model's [0, 1] encoding the
        same way, merge_patches:678-680)."""
        out = self.net(rgb01.permute(0, 3, 1, 2))
        return _unit(torch.clamp(out, 0.0, 1.0) * 2.0 - 1.0, 1)

    def predict_normals(self, rgb: np.ndarray) -> np.ndarray:
        img = np.asarray(rgb, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        H, W = img.shape[:2]
        S = IMAGE_SIZE
        with torch.inference_mode(), full_float32():
            x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
            if self.resolution == "low" or H <= S or W <= S:
                # the reference's low-res path (run_monocular_normals:201-224)
                small = resize(x, (S, S, 3), "bilinear")
                n = self._run_patches(small[None])[0].permute(1, 2, 0)
                n = _unit(resize(n, (H, W, 3), "bilinear"), -1)
                return n.cpu().numpy().astype(np.float32)
            _, _, crops = crop_grid(H, W)
            batch = torch.stack([x[py:py + S, px:px + S]
                                 for py, px in crops.values()])
            out = self._run_patches(batch).cpu().numpy()
        merged = merge_patches(dict(zip(crops, out)), H, W)
        return merged.transpose(1, 2, 0).astype(np.float32)
