"""ATSS-style grounding postprocessor on fixed shapes, on the device.

Counterpart of fusionsense_tpu/detection/postprocess.py (reference
PartSlip/GLIP/maskrcnn_benchmark/modeling/rpn/inference.py:592-768): per
level, sigmoid token logits -> per-phrase scores through the positive map
(MEAN aggregation), times sigmoid centerness, threshold 0.05, the top
1,000 candidates, boxes decoded against the anchors (weights 10, 10, 5,
5), score = sqrt(cls * ctr); across levels: class-aware NMS at 0.6, 100
detections.

The top k is taken from a stable descending sort, so among equal scores
(the many exact zeros below the threshold) the lowest index comes first,
as lax.top_k orders them: the zero rows reach ml_nms's class offsets, so
another choice of zero rows would move the boxes' IoUs.
"""
from __future__ import annotations

import math

import torch

from fusionsense_tpu_torch.ops.detection import ml_nms

PRE_NMS_THRESH = 0.05
PRE_NMS_TOP_N = 1000
NMS_THRESH = 0.6
MAX_DETECTIONS = 100


def decode_boxes(preds: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(N, 4) regression deltas + (N, 4) xyxy anchors -> (N, 4) boxes."""
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = (anchors[:, 2] + anchors[:, 0]) / 2.0
    cy = (anchors[:, 3] + anchors[:, 1]) / 2.0
    dx = preds[:, 0] / 10.0
    dy = preds[:, 1] / 10.0
    dw = torch.clamp_max(preds[:, 2] / 5.0, math.log(1000.0 / 16))
    dh = torch.clamp_max(preds[:, 3] / 5.0, math.log(1000.0 / 16))
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1),
                        pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)], dim=1)


def scores_from_token_logits(dot_logits: torch.Tensor,
                             positive_map: torch.Tensor) -> torch.Tensor:
    """(N, T) token logits + (C, T) normalized span map -> (N, C) scores
    (MEAN aggregation = matmul with the row-normalized map)."""
    return torch.sigmoid(dot_logits) @ positive_map.T


def top_k_stable(x: torch.Tensor, k: int):
    """lax.top_k of a vector: the k largest, the lower index first among
    equal values."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def select_level(dot_logits, bbox_reg, centerness, anchors, positive_map,
                 top_n: int = PRE_NMS_TOP_N):
    """One FPN level -> (top_n,) boxes/scores/labels/valid."""
    cls = scores_from_token_logits(dot_logits, positive_map)   # (N, C)
    c = cls.shape[1]
    keep = cls > PRE_NMS_THRESH
    cls = cls * torch.sigmoid(centerness)[:, None]
    flat = torch.where(keep, cls, 0.0).reshape(-1)
    top_scores, top_idx = top_k_stable(flat, min(top_n, flat.shape[0]))
    loc = top_idx // c
    label = (top_idx % c + 1).to(torch.int32)   # 1-based like the reference
    boxes = decode_boxes(bbox_reg[loc], anchors[loc])
    valid = top_scores > 0.0
    return boxes, torch.sqrt(top_scores), label, valid


def postprocess(level_outputs, anchors, positive_map, image_size,
                max_det: int = MAX_DETECTIONS):
    """level_outputs: list of (bbox (N,4), ctr (N,), dot (N,T)); anchors:
    list of (N, 4). Returns (boxes, scores, labels, valid) with max_det rows,
    boxes clipped to image_size=(H, W)."""
    parts = [select_level(dot, bbox, ctr, anc, positive_map)
             for (bbox, ctr, dot), anc in zip(level_outputs, anchors)]
    boxes, scores, labels, valid = (torch.cat([p[i] for p in parts])
                                    for i in range(4))
    H, W = image_size
    boxes = torch.stack([torch.clamp(boxes[:, 0], 0, W - 1),
                         torch.clamp(boxes[:, 1], 0, H - 1),
                         torch.clamp(boxes[:, 2], 0, W - 1),
                         torch.clamp(boxes[:, 3], 0, H - 1)], dim=1)
    scores = torch.where(valid, scores, 0.0)
    keep, keep_valid = ml_nms(boxes, scores, labels, NMS_THRESH,
                              max_out=max_det)
    safe = torch.clamp_min(keep, 0).to(torch.int64)
    return (boxes[safe], scores[safe], labels[safe],
            keep_valid & (scores[safe] > 0))
