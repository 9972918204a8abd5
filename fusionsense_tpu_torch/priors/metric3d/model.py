"""Metric3D-v2-class metric depth + normal network, in NCHW.

Counterpart of fusionsense_tpu/priors/metric3d/model.py, the in-repo net
of the published Metric3D v2 design (arXiv 2404.15506) that fills the
orchestrator's default depth-prior slot (reference utils/
metric3dv2_depth_generation.py:79-81):
- a DINOv2 ViT WITH register tokens, tapped at four depths,
- a DPT reassembly/fusion pyramid for the context feature,
- a joint [depth, normal, kappa] prediction refined by a RAFT-style
  ConvGRU loop,
- learned convex upsampling to the input resolution,
- canonical depth bounded by a sigmoid into [d_min, d_max] (the caller
  de-canonicalises by fx / 1000, priors/metric3d/wrapper.py).
It reuses DSINE's ConvGRU and convex_upsample and Depth-Anything's ViT
Block and DPT fusion blocks, as the JAX net does. Parameter names are those
of the torch replica the JAX converter is pinned to (see its convert.py).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from fusionsense_tpu_torch.priors.depth_anything.dpt import (
    FusionBlock, fuse, reassemble_layers, resize_ac,
)
from fusionsense_tpu_torch.priors.depth_anything.vit import (
    Block, PatchEmbed, resample_pos_embed,
)
from fusionsense_tpu_torch.priors.dsine.model import ConvGRU, convex_upsample


@dataclasses.dataclass(frozen=True)
class M3DConfig:
    dim: int = 384               # vit_small
    depth: int = 12
    heads: int = 6
    patch: int = 14
    registers: int = 4
    native_grid: int = 37
    layer_idx: tuple = (2, 5, 8, 11)
    out_channels: tuple = (48, 96, 192, 384)
    features: int = 128          # decoder width
    hidden_dim: int = 64         # GRU hidden
    num_iter: int = 4
    downsample: int = 7          # convex-upsample factor (patch/2)
    d_min: float = 0.3           # canonical depth range (metres at f=1000)
    d_max: float = 150.0


def tiny_m3d() -> M3DConfig:
    return M3DConfig(dim=32, depth=4, heads=2, registers=2, native_grid=4,
                     layer_idx=(0, 1, 2, 3), out_channels=(8, 16, 24, 32),
                     features=16, hidden_dim=8, num_iter=2)


class RegisterViT(nn.Module):
    """DINOv2 with registers: [cls, reg x R, patches]; the position
    embedding applies to cls and patches only. -> the chosen layers' patch
    tokens, each (B, D, h, w), through the final LayerNorm."""

    def __init__(self, cfg: M3DConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = PatchEmbed(c.dim, c.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, c.registers, c.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + c.native_grid ** 2,
                                                  c.dim))
        self.blocks = nn.ModuleList([Block(c.dim, c.heads, 4.0)
                                     for _ in range(c.depth)])
        self.norm = nn.LayerNorm(c.dim, eps=1e-6)

    def forward(self, img):
        c = self.cfg
        B = img.shape[0]
        y = self.patch_embed(img)
        h, w = y.shape[2:]
        pe = resample_pos_embed(self.pos_embed[0], c.native_grid, h, w)
        x = torch.cat([(self.cls_token[:, 0] + pe[:1])[:, None].expand(B, -1, -1),
                       self.register_tokens.expand(B, -1, -1),
                       y.flatten(2).transpose(1, 2) + pe[1:]], dim=1)
        outs = []
        want = set(c.layer_idx)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                z = self.norm(x)[:, 1 + c.registers:]
                outs.append(z.transpose(1, 2).reshape(B, c.dim, h, w))
        return outs


class M3DDecoder(nn.Module):
    """DPT reassembly + fusion -> context; the initial joint prediction;
    ConvGRU refinement; convex upsample; the bounded outputs."""

    def __init__(self, cfg: M3DConfig):
        super().__init__()
        c = self.cfg = cfg
        f, hd = c.features, c.hidden_dim
        self.projects, self.resize_layers = reassemble_layers(
            c.dim, c.out_channels)
        self.scratch = nn.ModuleList([nn.Conv2d(oc, f, 3, padding=1,
                                                bias=False)
                                      for oc in c.out_channels])
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(f, skip=i != 4))
        self.init_pred = nn.Conv2d(f, 5, 3, padding=1)
        self.init_hidden = nn.Conv2d(f, hd, 3, padding=1)
        self.init_context = nn.Conv2d(f, hd, 3, padding=1)
        self.gru = ConvGRU(hd, hd + 5, ks=3)
        self.delta_hidden = nn.Conv2d(hd, hd, 3, padding=1)
        self.delta_head = nn.Conv2d(hd, 5, 3, padding=1)
        self.up_mask = nn.Conv2d(hd, 9 * c.downsample ** 2, 3, padding=1)

    def forward(self, feats, out_hw):
        c = self.cfg
        levels = [self.scratch[i](self.resize_layers[i](self.projects[i](t)))
                  for i, t in enumerate(feats)]
        ctx = fuse([getattr(self, f"refinenet{i}") for i in range(1, 5)],
                   levels)
        # the iterative head's grid: the output over the upsample factor
        ctx = resize_ac(ctx, out_hw[0] // c.downsample,
                        out_hw[1] // c.downsample)

        pred = self.init_pred(ctx)        # [depth_logit, nx, ny, nz, kappa]
        hidden = torch.tanh(self.init_hidden(ctx))
        inp = F.relu(self.init_context(ctx))
        for _ in range(c.num_iter):
            hidden = self.gru(hidden, torch.cat([inp, pred], 1))
            pred = pred + self.delta_head(F.relu(self.delta_hidden(hidden)))

        up = convex_upsample(pred, self.up_mask(hidden), c.downsample)
        up = resize_ac(up, *out_hw)
        s = torch.sigmoid(up[:, 0])
        depth = c.d_min * torch.exp(s * math.log(c.d_max / c.d_min))
        n = up[:, 1:4]
        normal = n / torch.clamp_min(torch.linalg.norm(n, dim=1, keepdim=True),
                                     1e-12)
        return depth, normal, F.softplus(up[:, 4])


class Metric3D(nn.Module):
    """(B, 3, H, W) normalised image -> (canonical depth (B, H, W), normal
    (B, 3, H, W), kappa (B, H, W))."""

    def __init__(self, cfg: M3DConfig = M3DConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = RegisterViT(cfg)
        self.decoder = M3DDecoder(cfg)

    def forward(self, img):
        return self.decoder(self.encoder(img), img.shape[2:])
