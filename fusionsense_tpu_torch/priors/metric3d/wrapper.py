"""Metric3D v2 generation stage: the orchestrator's default depth+normal
prior pipeline, exactly as the reference drives it.

Counterpart of fusionsense_tpu/priors/metric3d/wrapper.py: the same numpy
pre/post code and file writers (host side; Pillow imported in `generate`).

Behavioral contract (reference utils/metric3dv2_depth_generation.py:54-247,
which IS on disk — the network itself comes via torch.hub):

- keep-ratio resize of the RGB into a (720, 1280) canvas, ImageNet-mean
  padding split half/half per side (:121-135),
- ImageNet mean/std normalization in 0..255 units (:138-141),
- model inference in the CANONICAL camera space, un-pad, bilinear
  upsample back to the original resolution (:150-160),
- de-canonicalization: depth *= fx_scaled / 1000 (the canonical focal),
  clamp to [0, 300] m (:163-166),
- artifacts: uint16 depth PNGs at scale_factor=1000 into
  `metric3d_depth_result/` with the capture's d_-prefix naming, and
  normal visualizations ((n+1)/2 * 255 uint8) into
  `metric3d_normal_result/` (:168-207; consumed downstream by
  utils/generate_pcd.py:64).

The model is pluggable: anything with
``predict_canonical(rgb_normalized) -> (depth (h, w), normal (h, w, 3))``
operating in canonical space — the port's Metric3D predictor
(priors/metric3d/predictor.py), or a mock in tests.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Protocol

import numpy as np

CANONICAL_FOCAL = 1000.0
INPUT_SIZE = (720, 1280)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
DEPTH_CLAMP = 300.0
DEPTH_SCALE = 1000.0


class CanonicalModel(Protocol):
    def predict_canonical(self, rgb: np.ndarray) -> tuple: ...


def _resize_bilinear(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """torch F.interpolate(mode=bilinear, align_corners=False) semantics —
    NO antialiasing on downscale (jax.image.resize antialiases, which
    deviates from the reference's cv2/torch resizes)."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    x = np.asarray(x, np.float32)
    H, W = x.shape[:2]
    ys = np.clip((np.arange(h) + 0.5) * (H / h) - 0.5, 0, H - 1)
    xs = np.clip((np.arange(w) + 0.5) * (W / w) - 0.5, 0, W - 1)
    y0 = np.minimum(np.floor(ys).astype(np.int64), H - 1)
    x0 = np.minimum(np.floor(xs).astype(np.int64), W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    top = x[y0][:, x0] * (1 - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (1 - wx) + x[y1][:, x1] * wx
    y = top * (1 - wy) + bot * wy
    return y[..., 0] if squeeze else y


def prepare_input(rgb: np.ndarray, fx: float,
                  input_size: tuple = INPUT_SIZE):
    """uint8/float RGB (H, W, 3) -> (normalized (h', w', 3), pad_info,
    scaled_fx). Mirrors :121-141."""
    img = np.asarray(rgb, np.float32)
    if img.max() <= 2.0:
        img = img * 255.0
    H, W = img.shape[:2]
    scale = min(input_size[0] / H, input_size[1] / W)
    nh, nw = int(H * scale), int(W * scale)
    small = _resize_bilinear(img, nh, nw)
    pad_h, pad_w = input_size[0] - nh, input_size[1] - nw
    ph0, pw0 = pad_h // 2, pad_w // 2
    canvas = np.empty((*input_size, 3), np.float32)
    canvas[:] = PIXEL_MEAN
    canvas[ph0:ph0 + nh, pw0:pw0 + nw] = small
    out = (canvas - PIXEL_MEAN) / PIXEL_STD
    pad_info = (ph0, pad_h - ph0, pw0, pad_w - pw0)
    return out, pad_info, fx * scale


def postprocess_depth(pred_depth: np.ndarray, pad_info, fx_scaled: float,
                      out_hw: tuple) -> np.ndarray:
    """Un-pad, upsample to the capture resolution, de-canonicalize, clamp
    (:150-166)."""
    ph0, ph1, pw0, pw1 = pad_info
    h, w = pred_depth.shape
    d = pred_depth[ph0:h - ph1, pw0:w - pw1]
    d = _resize_bilinear(d, *out_hw)
    d = d * (fx_scaled / CANONICAL_FOCAL)
    return np.clip(d, 0.0, DEPTH_CLAMP)


def postprocess_normal(pred_normal: np.ndarray, pad_info) -> np.ndarray:
    """Un-pad only — the reference keeps normals at model resolution
    (:183-188)."""
    ph0, ph1, pw0, pw1 = pad_info
    h, w = pred_normal.shape[:2]
    return pred_normal[ph0:h - ph1, pw0:w - pw1]


@dataclasses.dataclass
class Metric3DPipeline:
    """File-artifact generation matching the reference layout. The canvas
    is `input_size`: the reference's (720, 1280) by default, the
    predictor's patch-14 canvas from Metric3DPredictor.pipeline() (the JAX
    package's pipeline() keeps (720, 1280), which its net cannot take)."""

    model: CanonicalModel
    scale_factor: float = DEPTH_SCALE
    input_size: tuple = INPUT_SIZE

    def predict(self, rgb: np.ndarray, fx: float):
        """-> (metric depth (H, W) float32, normal (h', w', 3) in [-1, 1])."""
        inp, pad_info, fx_s = prepare_input(rgb, fx, self.input_size)
        depth_c, normal_c = self.model.predict_canonical(inp)
        depth = postprocess_depth(np.asarray(depth_c), pad_info, fx_s,
                                  rgb.shape[:2])
        normal = postprocess_normal(np.asarray(normal_c), pad_info)
        return depth.astype(np.float32), normal.astype(np.float32)

    def generate(self, root_dir, output_dir, fx: float,
                 img_dir: str = "images",
                 output_depth_path: str = "metric3d_depth_result",
                 output_normal_path: str = "metric3d_normal_result"):
        """Reference metric3d_depth_generation(:238-247): run every frame,
        write uint16 depth PNGs (d_-renamed) and normal visualizations."""
        from PIL import Image

        root = Path(root_dir)
        out_d = Path(output_dir) / output_depth_path
        out_n = Path(output_dir) / output_normal_path
        out_d.mkdir(parents=True, exist_ok=True)
        out_n.mkdir(parents=True, exist_ok=True)
        names = sorted(p.name for p in (root / img_dir).iterdir()
                       if p.suffix == ".png")
        for name in names:
            rgb = np.asarray(Image.open(root / img_dir / name).convert("RGB"))
            depth, normal = self.predict(rgb, fx)
            d16 = (self.scale_factor * depth).astype(np.uint16)
            Image.fromarray(d16).save(out_d / name.replace("c_", "d_"))
            vis = ((normal + 1.0) / 2.0 * 255.0).astype(np.uint8)
            Image.fromarray(vis).save(out_n / name)
        return out_d, out_n
