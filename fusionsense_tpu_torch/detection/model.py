"""GLIP-class grounded detector: the model and its predictor.

Counterpart of fusionsense_tpu/detection/model.py:
- GLIPModel (reference GeneralizedVLRCNN, PartSlip/GLIP/.../detector/
  generalized_vl_rcnn.py:63-300) with the published checkpoint's top-level
  names: backbone.body (Swin), backbone.fpn, language_backbone.body.model
  (BERT), rpn.head (VLDyHead);
- GLIPPredictor (reference GLIPDemo, engine/predictor_glip.py:27-240):
  BGR255 normalisation, shorter side to 800 (jax.image.resize's
  antialiased bilinear, priors/resize.py), padding to /32, the caption of
  part names joined by " . ", per-part token spans -> normalised positive
  map, the ATSS postprocess, the score threshold. It runs the net on its
  device under torch.inference_mode with TF32 off (priors/tf32.py), and
  returns touch_select.partseg.Detection in original image coordinates.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from fusionsense_tpu_torch.detection.anchors import pyramid_anchors
from fusionsense_tpu_torch.detection.bert import BertConfig, BertEncoder
from fusionsense_tpu_torch.detection.fpn import FPN
from fusionsense_tpu_torch.detection.head import VLDyHead
from fusionsense_tpu_torch.detection.postprocess import postprocess
from fusionsense_tpu_torch.detection.swin import SwinConfig, SwinTransformer
from fusionsense_tpu_torch.detection.tokenizer import (
    Encoding, WordPieceTokenizer,
)

# BGR255 normalization (glip_Swin_L.yaml INPUT)
PIXEL_MEAN = np.array([103.530, 116.280, 123.675], np.float32)
PIXEL_STD = np.array([57.375, 57.120, 58.395], np.float32)


@dataclasses.dataclass(frozen=True)
class GLIPConfig:
    swin: SwinConfig = SwinConfig()
    bert: BertConfig = BertConfig()
    max_query_len: int = 256
    channels: int = 256          # DYHEAD.CHANNELS == BACKBONE.OUT_CHANNELS
    num_convs: int = 8           # DYHEAD.NUM_CONVS
    fuse_embed: int = 2048


def tiny_config() -> GLIPConfig:
    """A small-width config for tests (same topology, ~1000x fewer flops)."""
    return GLIPConfig(
        swin=SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                        num_heads=(1, 2, 2, 2), window=4),
        bert=BertConfig(vocab_size=128, hidden=32, layers=2, heads=2,
                        intermediate=64, max_positions=64),
        max_query_len=32, channels=32, num_convs=2, fuse_embed=64,
    )


class _Backbone(nn.Module):
    def __init__(self, cfg: GLIPConfig):
        super().__init__()
        self.body = SwinTransformer(cfg.swin)
        self.fpn = FPN(tuple(cfg.swin.embed_dim * 2 ** i
                             for i in cfg.swin.out_indices), cfg.channels)


class _LanguageBackbone(nn.Module):
    def __init__(self, cfg: GLIPConfig):
        super().__init__()
        self.body = nn.Module()
        self.body.model = BertEncoder(cfg.bert)


class _RPN(nn.Module):
    def __init__(self, cfg: GLIPConfig):
        super().__init__()
        self.head = VLDyHead(cfg.bert, cfg.channels, cfg.num_convs,
                             cfg.fuse_embed)


class GLIPModel(nn.Module):
    def __init__(self, cfg: GLIPConfig = GLIPConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = _Backbone(cfg)
        self.language_backbone = _LanguageBackbone(cfg)
        self.rpn = _RPN(cfg)

    def forward(self, image, input_ids, attention_mask):
        """image (3, H, W) normalized BGR; ids/mask (T,).

        Returns list of per-level (bbox (N,4), centerness (N,),
        dot_logits (N, T)), locations row-major."""
        feats = self.backbone.fpn(self.backbone.body(image))
        lang = self.language_backbone.body.model(input_ids, attention_mask)
        return self.rpn.head(feats, lang, attention_mask)


def build_caption(part_names: list[str]) -> tuple[str, list[tuple[int, int]]]:
    """'a . b . ' caption + char span per part
    (predictor_glip.py:183-199)."""
    caption = ""
    spans = []
    for name in part_names:
        spans.append((len(caption), len(caption) + len(name)))
        caption += name + " . "
    return caption, spans


def positive_map_from_spans(enc: Encoding, spans: list[tuple[int, int]],
                            max_len: int) -> np.ndarray:
    """(C, max_len) row-normalized token-span map
    (predictor_glip.py:412-445)."""
    pm = np.zeros((len(spans), max_len), np.float32)
    for j, (beg, end) in enumerate(spans):
        beg_pos = enc.char_to_token(beg)
        end_pos = enc.char_to_token(end - 1)
        if beg_pos is None:
            beg_pos = enc.char_to_token(beg + 1) or enc.char_to_token(beg + 2)
        if end_pos is None:
            end_pos = enc.char_to_token(end - 2) or enc.char_to_token(end - 3)
        if beg_pos is None or end_pos is None:
            continue
        pm[j, beg_pos:end_pos + 1] = 1.0
    return pm / (pm.sum(-1, keepdims=True) + 1e-6)


def preprocess_image(rgb: np.ndarray, min_size: int = 800,
                     max_size: int = 1333,
                     divisibility: int = 32) -> tuple[np.ndarray, float]:
    """uint8/float RGB (H, W, 3) -> normalized BGR (H', W', 3) padded to
    /32, plus the resize scale (original -> model coords). The resize is
    jax.image.resize's bilinear (priors/resize.py), on the CPU."""
    from fusionsense_tpu_torch.priors.resize import resize

    h, w = rgb.shape[:2]
    scale = min_size / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    img = np.asarray(rgb, np.float32)
    if img.max() > 2.0:
        img = img / 255.0
    if (nh, nw) != (h, w):
        img = resize(torch.from_numpy(np.ascontiguousarray(img)),
                     (nh, nw, 3), "bilinear").numpy()
    bgr = img[..., ::-1] * 255.0
    bgr = (bgr - PIXEL_MEAN) / PIXEL_STD
    ph = -nh % divisibility
    pw = -nw % divisibility
    if ph or pw:
        bgr = np.pad(bgr, ((0, ph), (0, pw), (0, 0)))
    return bgr.astype(np.float32), scale


def _level_shapes(hw: tuple[int, int]) -> list[tuple[int, int]]:
    H, W = hw
    return [((H + s - 1) // s, (W + s - 1) // s) for s in (8, 16, 32, 64, 128)]


class GLIPPredictor:
    """Detector-protocol wrapper: rgb + part names -> scored boxes."""

    def __init__(self, net: GLIPModel, tokenizer: WordPieceTokenizer,
                 min_size: int = 800, confidence_threshold: float = 0.5,
                 device=None):
        from fusionsense_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.tokenizer = tokenizer
        self.min_size = min_size
        self.thresh = confidence_threshold

    def run(self, image: np.ndarray, ids, mask, positive_map):
        """The net and the postprocess on a preprocessed (H, W, 3) image:
        (boxes, scores, labels, valid) on the device, and the head's
        per-level outputs."""
        from fusionsense_tpu_torch.priors.tf32 import full_float32

        dev = self.device
        hw = image.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(image.transpose(2, 0, 1)))
        with torch.inference_mode(), full_float32():
            outs = self.net(x.to(dev), torch.as_tensor(ids, device=dev),
                            torch.as_tensor(mask, device=dev))
            anchors = [torch.from_numpy(a).to(dev)
                       for a in pyramid_anchors(_level_shapes(hw))]
            det = postprocess(outs, anchors,
                              torch.as_tensor(positive_map, device=dev), hw)
        return det, outs

    def encode(self, part_names: list[str]):
        """(ids, mask, positive map) of the caption of `part_names`."""
        caption, spans = build_caption(part_names)
        enc = self.tokenizer.encode(caption)
        pm = positive_map_from_spans(enc, spans, len(enc.ids))
        return (np.asarray(enc.ids, np.int64), np.asarray(enc.mask, np.int64),
                pm)

    def detect(self, rgb: np.ndarray, part_names: list[str]):
        from fusionsense_tpu_torch.touch_select.partseg import Detection

        image, scale = preprocess_image(rgb, self.min_size)
        (boxes, scores, labels, valid), _ = self.run(
            image, *self.encode(part_names))
        boxes, scores, labels, valid = (t.cpu().numpy() for t in (
            boxes, scores, labels, valid))
        keep = valid & (scores > self.thresh)
        return Detection(boxes=boxes[keep] / scale,
                         labels=[int(l) - 1 for l in labels[keep]],
                         scores=scores[keep])
