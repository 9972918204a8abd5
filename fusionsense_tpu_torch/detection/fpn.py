"""RetinaNet-style FPN over the Swin stages, on (C, h, w) maps.

Counterpart of fusionsense_tpu/detection/fpn.py, with the published
checkpoint's module names (reference PartSlip/GLIP/maskrcnn_benchmark/
modeling/backbone/fpn.py: fpn_inner2..4 and fpn_layer2..4, the first
level having no input; LastLevelP6P7 as top_blocks.p6 / p7): lateral 1x1,
top-down nearest upsample, 3x3 output convs, P6 = conv/2(P5),
P7 = conv/2(relu(P6)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _upsample_nearest(x, h, w):
    """Repeat both axes by the ceiling ratio of the heights, then crop to
    (h, w) — not F.interpolate(mode="nearest") where sizes do not divide."""
    ry = h // x.shape[1] + (h % x.shape[1] > 0)
    y = torch.repeat_interleave(torch.repeat_interleave(x, ry, dim=1), ry,
                                dim=2)
    return y[:, :h, :w]


class LastLevelP6P7(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.p6 = nn.Conv2d(channels, channels, 3, 2, 1)
        self.p7 = nn.Conv2d(channels, channels, 3, 2, 1)


class FPN(nn.Module):
    def __init__(self, in_channels=(384, 768, 1536), out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 2}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_layer{i + 2}",
                            nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.top_blocks = LastLevelP6P7(out_channels)

    def forward(self, feats):       # [C3, C4, C5] -> [P3..P7]
        n = self.n
        inners = [getattr(self, f"fpn_inner{i + 2}")(f)
                  for i, f in enumerate(feats)]
        last = inners[-1]
        results = [getattr(self, f"fpn_layer{n + 1}")(last)]
        for i in range(n - 2, -1, -1):
            last = inners[i] + _upsample_nearest(last, *inners[i].shape[1:])
            results.insert(0, getattr(self, f"fpn_layer{i + 2}")(last))
        p6 = self.top_blocks.p6(results[-1])
        p7 = self.top_blocks.p7(F.relu(p6))
        return results + [p6, p7]

