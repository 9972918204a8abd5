"""EfficientNet feature encoder with tf SAME padding (inference only).

Counterpart of fusionsense_tpu/priors/dsine/efficientnet.py. DSINE's
encoder is geffnet's `tf_efficientnet_b5_ap` run module by module, keeping
the output of every block stage (reference dn_splatter/scripts/dsine/
submodules.py:19-39); the decoder reads the stages at strides /2, /4, /8,
/16 and the conv_head output at /32, before its BatchNorm.

tf semantics: asymmetric SAME padding (F.pad, then a conv with padding 0),
BatchNorm eps 1e-3 on stored running statistics, swish, squeeze-excite
widths from the block's INPUT channels. Parameter names are geffnet's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) tf SAME padding of one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Conv2d with tf SAME padding, computed from the input's size."""

    def __init__(self, c_in, c_out, k, stride=1, groups=1, bias=False):
        super().__init__(c_in, c_out, k, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        ph = same_pads(x.shape[-2], self.kernel_size[0], self.stride[0])
        pw = same_pads(x.shape[-1], self.kernel_size[1], self.stride[1])
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on stored statistics: weight, bias, running_mean and
    running_var, the names of nn.BatchNorm2d without its step counter."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, c, 1)

    def forward(self, x):
        s = F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(s))


class DepthwiseSeparable(nn.Module):
    """Stage-0 block: dw conv + SE + pointwise (no expansion)."""

    def __init__(self, c_in, c_out, k, stride, se_reduced):
        super().__init__()
        self.conv_dw = Conv2dSame(c_in, c_in, k, stride, groups=c_in)
        self.bn1 = FrozenBatchNorm2d(c_in)
        self.se = SqueezeExcite(c_in, se_reduced)
        self.conv_pw = Conv2dSame(c_in, c_out, 1)
        self.bn2 = FrozenBatchNorm2d(c_out)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x):
        y = self.se(F.silu(self.bn1(self.conv_dw(x))))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class InvertedResidual(nn.Module):
    """MBConv: 1x1 expand + dw + SE + 1x1 project."""

    def __init__(self, c_in, c_out, k, stride, expand, se_reduced):
        super().__init__()
        mid = c_in * expand
        self.conv_pw = Conv2dSame(c_in, mid, 1)
        self.bn1 = FrozenBatchNorm2d(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid)
        self.bn2 = FrozenBatchNorm2d(mid)
        self.se = SqueezeExcite(mid, se_reduced)
        self.conv_pwl = Conv2dSame(mid, c_out, 1)
        self.bn3 = FrozenBatchNorm2d(c_out)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = self.se(F.silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    """B5 by default; `tiny_effnet` below for tests."""
    stem: int = 48
    head: int = 2048
    # per stage: (repeats, out_ch, kernel, stride, expand)
    stages: tuple = ((3, 24, 3, 1, 1), (5, 40, 3, 2, 6), (5, 64, 5, 2, 6),
                     (7, 128, 3, 2, 6), (7, 176, 5, 1, 6), (9, 304, 5, 2, 6),
                     (3, 512, 3, 1, 6))


def tiny_effnet() -> EffNetConfig:
    return EffNetConfig(
        stem=8, head=64,
        stages=((1, 8, 3, 1, 1), (1, 12, 3, 2, 6), (1, 16, 5, 2, 6),
                (1, 24, 3, 2, 6), (1, 32, 5, 1, 6), (1, 40, 5, 2, 6),
                (1, 48, 3, 1, 6)))


def stage_channels(cfg: EffNetConfig) -> dict:
    """Channels of the features the decoder reads."""
    outs = [s[1] for s in cfg.stages]
    return {"s2": outs[0], "s4": outs[1], "s8": outs[2], "s16": outs[4],
            "head": cfg.head}


class EfficientNet(nn.Module):
    """(B, 3, H, W) -> {s2, s4, s8, s16, head (/32)} feature maps."""

    def __init__(self, cfg: EffNetConfig = EffNetConfig()):
        super().__init__()
        self.conv_stem = Conv2dSame(3, cfg.stem, 3, 2)
        self.bn1 = FrozenBatchNorm2d(cfg.stem)
        blocks = []
        c_in = cfg.stem
        for reps, c_out, k, s, exp in cfg.stages:
            stage = []
            for j in range(reps):
                stride = s if j == 0 else 1
                # tf convention: SE squeeze = block input channels // 4
                se_red = max(1, c_in // 4)
                if exp == 1:
                    stage.append(DepthwiseSeparable(c_in, c_out, k, stride,
                                                    se_red))
                else:
                    stage.append(InvertedResidual(c_in, c_out, k, stride,
                                                  exp, se_red))
                c_in = c_out
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.ModuleList(blocks)
        self.conv_head = Conv2dSame(c_in, cfg.head, 1)

    def forward(self, x):
        x = F.silu(self.bn1(self.conv_stem(x)))
        stage_out = []
        for stage in self.blocks:
            x = stage(x)
            stage_out.append(x)
        # DSINE reads conv_head before its BatchNorm (submodules.py index 11)
        return {"s2": stage_out[0], "s4": stage_out[1], "s8": stage_out[2],
                "s16": stage_out[4], "head": self.conv_head(x)}
