"""Shared layers of the grounded detector, as nn.Modules on channel-first
(C, H, W) maps of one image.

Counterpart of fusionsense_tpu/detection/layers.py; the module names are
those of the published checkpoint (reference PartSlip/GLIP/.../rpn/
vldyhead.py:97-138 Conv3x3Norm with `conv` and `bn`; layers/dyrelu.py's
`fc`):
- Conv3x3Norm: the modulated deformable 3x3 (ops.detection.deform_conv2d),
  then GroupNorm(16);
- DyReLU: dynamic ReLU-B, (a, b) predicted from the pooled feature;
- h_sigmoid: relu6(x + 3) / 6;
- Scale: a learnable scalar.
"""
from __future__ import annotations

import torch
from torch import nn

from fusionsense_tpu_torch.ops.detection import deform_conv2d


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class HSigmoid(nn.Module):
    def forward(self, x):
        return h_sigmoid(x)


class ModulatedDeformConv(nn.Module):
    """The 3x3 modulated deformable conv's parameters (weight OIHW, bias)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, offset, mask):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             stride=self.stride, padding=1)


class Conv3x3Norm(nn.Module):
    """Modulated-deformable 3x3 conv + GroupNorm(16). The caller passes
    (offset, mask) sampled at the OUTPUT spatial size — same contract as
    the reference's ModulatedDeformConv (vldyhead.py:108). (The JAX
    module's plain-conv and zero-offset variants have no caller there or
    here.)"""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv = ModulatedDeformConv(in_ch, out_ch, stride)
        self.bn = nn.GroupNorm(16, out_ch, eps=1e-5)

    def forward(self, x, offset, mask):      # x: (C, H, W)
        # the statistics of each group span the whole image, as torch's
        # GroupNorm on a batch of one
        return self.bn(self.conv(x, offset, mask)[None])[0]


class DyReLU(nn.Module):
    """Dynamic ReLU-B: out = max(x*a1+b1, x*a2+b2) with (a, b) predicted
    from the global-pooled feature (reference layers/dyrelu.py, exp=4)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // 4), nn.ReLU(),
                                nn.Linear(channels // 4, channels * 4),
                                HSigmoid())

    def forward(self, x):            # x: (C, H, W)
        y = self.fc(torch.mean(x, dim=(1, 2)))
        a1, b1, a2, b2 = (t[:, None, None] for t in torch.chunk(y, 4))
        a1 = (a1 - 0.5) * 2.0 + 1.0       # lambda_a = 2, init_a = [1, 0]
        a2 = (a2 - 0.5) * 2.0
        b1 = b1 - 0.5                     # init_b = [0, 0]
        b2 = b2 - 0.5
        return torch.maximum(x * a1 + b1, x * a2 + b2)


class Scale(nn.Module):
    """Learnable scalar multiplier (one per FPN level on bbox_pred)."""

    def __init__(self, init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x):
        return x * self.scale
