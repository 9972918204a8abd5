"""Omnidata DPT-Hybrid surface-normal network, in NCHW.

Counterpart of fusionsense_tpu/priors/omnidata/dpt_hybrid.py: the
reference's alternate normal prior, omnidata's
``DPTDepthModel(backbone="vitb_rn50_384", num_channels=3)`` loaded from
``omnidata_dpt_normal_v2.ckpt`` (reference
dn_splatter/scripts/normals_from_pretrain.py:309-322, 149-245), the
published MiDaS DPT-Hybrid architecture:

- ResNetV2-50 stem (weight-standardised convs + GroupNorm(min(32, C)),
  pre-activation bottlenecks, stage layout (3, 4, 9)) whose stage-1/2
  outputs feed the DPT pyramid directly,
- ViT-B/16 on the /16 stem feature (1x1 patch embedding, cls token, 24x24
  learned position grid resampled by jax.image.resize's cubic for another
  grid, 12 pre-LN blocks, exact GELU), tapped after blocks 9 and 12,
- the "project" readout (cls token concatenated, Linear + GELU) and the
  act_postprocess convs,
- the DPT scratch / refinenet stack (align_corners=True bilinear) and the
  3-channel normal head (final ReLU; callers clamp to [0, 1]).

Parameter names are the upstream MiDaS/timm state_dict keys
(`pretrained.model.*`, `pretrained.act_postprocess{3,4}.*`, `scratch.*`).
refinenet4 gets no skip input, so its resConfUnit1 never runs; the
published file carries its weights and the module keeps them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fusionsense_tpu_torch.priors.depth_anything.dpt import (
    FusionBlock, resize_ac,
)
from fusionsense_tpu_torch.priors.depth_anything.vit import (
    Attention, Mlp, resample_pos_embed,
)


@dataclasses.dataclass(frozen=True)
class OmniConfig:
    stem_width: int = 64
    stage_layout: tuple = (3, 4, 9)
    stage_width: int = 256            # stage i width = stage_width * 2**i
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    hooks: tuple = (8, 11)            # transformer taps (blocks 9 and 12)
    native_grid: int = 24             # pos-embed grid (384/16)
    features: int = 256               # DPT feature width
    out_channels: tuple = (256, 512, 768, 768)


def tiny_omni() -> OmniConfig:
    return OmniConfig(stem_width=8, stage_layout=(1, 1, 1), stage_width=16,
                      vit_dim=32, vit_depth=4, vit_heads=2, hooks=(1, 3),
                      native_grid=4, features=16, out_channels=(16, 32, 32, 32))


class StdConv2d(nn.Conv2d):
    """timm's StdConv2d: each output channel's kernel standardised over
    (in, kh, kw) with the biased variance, eps 1e-6 inside the rsqrt."""

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), keepdim=True, correction=0)
        w = (w - mean) * torch.rsqrt(var + 1e-6)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def std_conv(cin: int, cout: int, k: int, stride: int = 1) -> StdConv2d:
    return StdConv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


def group_norm(c: int) -> nn.GroupNorm:
    # min(32, C) groups: timm's 32 at real widths, fewer in the tiny config
    return nn.GroupNorm(min(32, c), c, eps=1e-5)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = std_conv(cin, cout, 1, stride)


class PreActBottleneck(nn.Module):
    """timm ResNetV2's pre-activation bottleneck; the first block of a
    stage projects its shortcut."""

    def __init__(self, cin: int, cout: int, stride: int, downsample: bool):
        super().__init__()
        mid = cout // 4
        self.downsample = Downsample(cin, cout, stride) if downsample else None
        self.norm1 = group_norm(cin)
        self.conv1 = std_conv(cin, mid, 1)
        self.norm2 = group_norm(mid)
        self.conv2 = std_conv(mid, mid, 3, stride)
        self.norm3 = group_norm(mid)
        self.conv3 = std_conv(mid, cout, 1)

    def forward(self, x):
        xp = F.relu(self.norm1(x))
        shortcut = x if self.downsample is None else self.downsample.conv(xp)
        y = self.conv1(xp)
        y = self.conv2(F.relu(self.norm2(y)))
        y = self.conv3(F.relu(self.norm3(y)))
        return y + shortcut


class Stem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv = std_conv(3, width, 7, 2)
        self.norm = group_norm(width)


class Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)


class ResNetV2(nn.Module):
    """(B, 3, H, W) -> the stages' outputs at /4, /8, /16."""

    def __init__(self, cfg: OmniConfig):
        super().__init__()
        self.stem = Stem(cfg.stem_width)
        stages, cin = [], cfg.stem_width
        for si, reps in enumerate(cfg.stage_layout):
            cout = cfg.stage_width * 2 ** si
            blocks = []
            for bi in range(reps):
                blocks.append(PreActBottleneck(
                    cin, cout, 2 if (bi == 0 and si > 0) else 1, bi == 0))
                cin = cout
            stages.append(Stage(blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        y = F.relu(self.stem.norm(self.stem.conv(x)))
        # 3x3 / 2 max pool; its padding is -inf, as the JAX net pads
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        outs = []
        for stage in self.stages:
            y = stage.blocks(y)
            outs.append(y)
        return outs


class Block(nn.Module):
    """Pre-LN ViT block (LayerNorm eps 1e-6, exact GELU)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: OmniConfig):
        super().__init__()
        self.backbone = ResNetV2(cfg)
        c_in = cfg.stage_width * 2 ** (len(cfg.stage_layout) - 1)
        self.proj = nn.Conv2d(c_in, cfg.vit_dim, 1)


class HybridViT(nn.Module):
    def __init__(self, cfg: OmniConfig):
        super().__init__()
        c = cfg
        self.patch_embed = PatchEmbed(c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.vit_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + c.native_grid ** 2, c.vit_dim))
        self.blocks = nn.ModuleList(
            [Block(c.vit_dim, c.vit_heads) for _ in range(c.vit_depth)])


class ProjectReadout(nn.Module):
    """The "project" readout: each patch token with the cls token
    concatenated, Linear + GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, t, h: int, w: int):
        tok = t[:, 1:]
        y = self.project(torch.cat([tok, t[:, :1].expand_as(tok)], dim=-1))
        return y.transpose(1, 2).reshape(t.shape[0], -1, h, w)


class Scratch(nn.Module):
    def __init__(self, cfg: OmniConfig):
        super().__init__()
        f = cfg.features
        for i, c in enumerate(cfg.out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(f))
        self.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1),
            nn.Identity(),                 # upstream's Interpolate (no params)
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 3, 1), nn.ReLU())


class OmnidataNormals(nn.Module):
    """(B, 3, H, W) image in [0, 1] -> (B, 3, H, W) normal map in [0, 1]
    (the omnidata encoding: n = out * 2 - 1 in its LUF camera frame)."""

    def __init__(self, cfg: OmniConfig = OmniConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.pretrained = nn.Module()
        self.pretrained.model = HybridViT(c)
        d, oc = c.vit_dim, c.out_channels
        self.pretrained.act_postprocess3 = nn.Sequential(
            ProjectReadout(d), nn.Identity(), nn.Identity(),
            nn.Conv2d(d, oc[2], 1))
        self.pretrained.act_postprocess4 = nn.Sequential(
            ProjectReadout(d), nn.Identity(), nn.Identity(),
            nn.Conv2d(d, oc[3], 1),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1))
        self.scratch = Scratch(c)

    def forward(self, img):
        c = self.cfg
        m = self.pretrained.model
        r1, r2, r3 = m.patch_embed.backbone(img)
        y = m.patch_embed.proj(r3)
        B, _, h, w = y.shape
        x = torch.cat([m.cls_token.expand(B, -1, -1),
                       y.flatten(2).transpose(1, 2)], dim=1)
        x = x + resample_pos_embed(m.pos_embed[0], c.native_grid, h, w)
        taps = []
        for i, blk in enumerate(m.blocks):
            x = blk(x)
            if i in c.hooks:
                taps.append(x)

        a3, a4 = self.pretrained.act_postprocess3, self.pretrained.act_postprocess4
        l3 = a3[3](a3[0](taps[0], h, w))
        l4 = a4[4](a4[3](a4[0](taps[1], h, w)))

        s = self.scratch
        p4 = s.refinenet4(s.layer4_rn(l4))
        p3 = s.refinenet3(p4, s.layer3_rn(l3))
        p2 = s.refinenet2(p3, s.layer2_rn(r2))
        p1 = s.refinenet1(p2, s.layer1_rn(r1))
        oc = s.output_conv
        # im2col + GEMM for this one conv: cuDNN's float32 (TF32 off)
        # choice for 3x3, 256 -> 128 at 160x160 and above takes 170-375 ms
        # and a 17 GB workspace on an H100 against 0.8 ms (PERF.md)
        with torch.backends.cudnn.flags(enabled=False):
            y = oc[0](p1)
        y = resize_ac(y, y.shape[2] * 2, y.shape[3] * 2)
        return oc[5](oc[4](oc[3](oc[2](y))))
