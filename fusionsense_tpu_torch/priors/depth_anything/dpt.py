"""DPT decode head of the Depth-Anything-V2 port, in NCHW.

Counterpart of fusionsense_tpu/priors/depth_anything/dpt.py:
Depth-Anything-V2's DPTHead (use_clstoken=False, the released
relative-depth checkpoints): a 1x1 projection per level, the resize stack
(x4 / x2 / identity / stride 2), 3x3 "scratch" convs onto a common width,
top-down fusion blocks with two residual conv units each, then the
two-stage output conv giving non-negative relative INVERSE depth at the
input resolution. Every resize in the head is bilinear with
align_corners=True, as upstream's. Parameter names are the checkpoint's
(`depth_head.*`).
"""
from __future__ import annotations

import dataclasses

import torch.nn.functional as F
from torch import nn

from fusionsense_tpu_torch.priors.depth_anything.vit import (
    DinoViT, ViTConfig, tiny_vit,
)


@dataclasses.dataclass(frozen=True)
class DAConfig:
    vit: ViTConfig = ViTConfig()
    out_channels: tuple = (48, 96, 192, 384)   # vits; vitb (96,192,384,768)
    features: int = 64                         # vits; vitb 128, vitl 256


def tiny_da() -> DAConfig:
    return DAConfig(vit=tiny_vit(), out_channels=(8, 16, 24, 32), features=16)


def resize_ac(x, h: int, w: int):
    """Bilinear resize of (B, C, H, W) with align_corners=True: output i
    samples input i * (H - 1) / (h - 1)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    """FeatureFusionBlock: merge the skip through resConfUnit1, refine
    through resConfUnit2, resize to out_hw, 1x1 out_conv. Without a skip
    input (the deepest level) it has no resConfUnit1."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        h, w = out_hw if out_hw is not None else (x.shape[2] * 2,
                                                  x.shape[3] * 2)
        return self.out_conv(resize_ac(x, h, w))


def reassemble_layers(dim: int, out_channels) -> tuple[nn.ModuleList, nn.ModuleList]:
    """The per-level 1x1 projections and the resize stack (x4 transposed
    conv, x2 transposed conv, identity, stride-2 conv)."""
    oc = out_channels
    projects = nn.ModuleList([nn.Conv2d(dim, c, 1) for c in oc])
    resize_layers = nn.ModuleList([
        nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
        nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
        nn.Identity(),
        nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
    return projects, resize_layers


def fuse(refinenets, levels):
    """Top-down fusion of the four levels (grids 4h, 2h, h, h/2); the last
    block upsamples 2x from the 4h grid."""
    l1, l2, l3, l4 = levels
    r1, r2, r3, r4 = refinenets
    p4 = r4(l4, out_hw=l3.shape[2:])
    p3 = r3(p4, l3, out_hw=l2.shape[2:])
    p2 = r2(p3, l2, out_hw=l1.shape[2:])
    return r1(p2, l1, out_hw=(l1.shape[2] * 2, l1.shape[3] * 2))


class Scratch(nn.Module):
    def __init__(self, cfg: DAConfig):
        super().__init__()
        f = cfg.features
        for i, c in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(f, skip=i != 4))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    def __init__(self, cfg: DAConfig):
        super().__init__()
        self.projects, self.resize_layers = reassemble_layers(
            cfg.vit.dim, cfg.out_channels)
        self.scratch = Scratch(cfg)

    def forward(self, feats, out_hw):
        s = self.scratch
        levels = []
        for i, (patch, _cls) in enumerate(feats):
            y = self.resize_layers[i](self.projects[i](patch))
            levels.append(getattr(s, f"layer{i + 1}_rn")(y))
        p1 = fuse([getattr(s, f"refinenet{i}") for i in range(1, 5)], levels)
        y = resize_ac(s.output_conv1(p1), *out_hw)
        return s.output_conv2(y)[:, 0]          # (B, H, W) relative inv depth


class DepthAnything(nn.Module):
    """(B, 3, H, W) normalised image -> (B, H, W) relative inverse depth."""

    def __init__(self, cfg: DAConfig = DAConfig()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoViT(cfg.vit)
        self.depth_head = DPTHead(cfg)

    def forward(self, img):
        return self.depth_head(self.pretrained(img), img.shape[2:])
