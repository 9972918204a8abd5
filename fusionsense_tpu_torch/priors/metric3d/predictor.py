"""Metric3D predictor: a DepthModel and NormalModel provider wrapping the
port's net with the reference's generation contract (wrapper.py).

Counterpart of fusionsense_tpu/priors/metric3d/predictor.py. The net runs
on the predictor's device, in eval mode, under torch.inference_mode, with
TF32 off (priors/tf32.py).
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.priors.metric3d.model import M3DConfig, Metric3D
from fusionsense_tpu_torch.priors.metric3d.wrapper import (
    CANONICAL_FOCAL, Metric3DPipeline, _resize_bilinear, postprocess_depth,
    postprocess_normal, prepare_input,
)
from fusionsense_tpu_torch.priors.tf32 import full_float32


class Metric3DPredictor:
    # the reference feeds a (720, 1280) canvas; patch-14 nets need
    # multiples of the patch, so this predictor snaps the canvas instead
    def __init__(self, net: Metric3D, input_size: tuple = (714, 1274),
                 device=None):
        from fusionsense_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.input_size = tuple(input_size)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: M3DConfig = M3DConfig(),
                        input_size: tuple = (714, 1274), device=None):
        from fusionsense_tpu_torch.priors.metric3d.convert import (
            load_metric3d_checkpoint,
        )

        return cls(load_metric3d_checkpoint(path, cfg), input_size, device)

    def predict_canonical(self, rgb_normalized: np.ndarray):
        """(h', w', 3) normalised canvas -> (canonical depth (h', w'),
        normal (h', w', 3)) as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(
            np.asarray(rgb_normalized, np.float32).transpose(2, 0, 1)))
        with torch.inference_mode(), full_float32():
            depth, normal, _kappa = self.net(x[None].to(self.device))
        return (depth[0].cpu().numpy(),
                normal[0].permute(1, 2, 0).cpu().numpy())

    # ---- DepthModel / NormalModel protocols -----------------------------
    def predict_depth(self, rgb: np.ndarray, fx: float) -> np.ndarray:
        inp, pad_info, fx_s = prepare_input(rgb, fx, self.input_size)
        depth_c, _ = self.predict_canonical(inp)
        return postprocess_depth(depth_c, pad_info, fx_s, rgb.shape[:2])

    def predict_normals(self, rgb: np.ndarray) -> np.ndarray:
        inp, pad_info, _ = prepare_input(rgb, CANONICAL_FOCAL,
                                         self.input_size)
        _, normal_c = self.predict_canonical(inp)
        n = postprocess_normal(normal_c, pad_info)
        n = _resize_bilinear(n, *rgb.shape[:2])
        return (n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-15)) \
            .astype(np.float32)

    def pipeline(self) -> Metric3DPipeline:
        """The file writer on this predictor's canvas."""
        return Metric3DPipeline(model=self, input_size=self.input_size)
