"""DINOv2 ViT encoder for the Depth-Anything-V2 port, in NCHW / (B, T, D).

Counterpart of fusionsense_tpu/priors/depth_anything/vit.py: a patch-14
conv embedding, the cls token, learned position embeddings resampled for a
grid other than the native one (jax.image.resize's cubic, priors/resize.py),
pre-LN blocks with LayerScale (LayerNorm eps 1e-6, exact GELU), and
get_intermediate_layers' semantics: the chosen blocks' patch tokens and cls
token, each through the FINAL LayerNorm. Parameter names are DINOv2's
(`pretrained.*` in a Depth-Anything-V2 checkpoint).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fusionsense_tpu_torch.priors.resize import resize


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    dim: int = 384              # vits=384, vitb=768, vitl=1024
    depth: int = 12             # vits/vitb=12, vitl=24
    heads: int = 6              # vits=6, vitb=12, vitl=16
    patch: int = 14
    mlp_ratio: float = 4.0
    native_grid: int = 37       # pos-embed grid the checkpoint was trained at
    layer_idx: tuple = (2, 5, 8, 11)   # DA-V2 intermediate layers (vits)


def tiny_vit() -> ViTConfig:
    return ViTConfig(dim=32, depth=4, heads=2, patch=14, native_grid=4,
                     layer_idx=(0, 1, 2, 3))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):                        # (B, T, D)
        B, T, D = x.shape
        hd = D // self.heads
        q, k, v = self.qkv(x).reshape(B, T, 3, self.heads, hd).permute(
            2, 0, 3, 1, 4)                       # each (B, heads, T, hd)
        att = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(B, T, D))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


def resample_pos_embed(pos: torch.Tensor, native: int, h: int, w: int):
    """(1 + native^2, D) learned pos embeds -> (1 + h*w, D) for the actual
    patch grid (DINOv2 interpolate_pos_encoding, jax.image.resize cubic)."""
    if h == native and w == native:
        return pos
    cls_pos, patch_pos = pos[:1], pos[1:]
    grid = patch_pos.reshape(native, native, -1)
    grid = resize(grid, (h, w, grid.shape[-1]), "bicubic")
    return torch.cat([cls_pos, grid.reshape(h * w, -1)], dim=0)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x)                      # (B, D, h, w)


class DinoViT(nn.Module):
    """(B, 3, H, W) normalised image -> [(patch tokens (B, D, h, w), cls
    token (B, D))] at the config's layer_idx."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.patch_embed = PatchEmbed(c.dim, c.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + c.native_grid ** 2,
                                                  c.dim))
        self.blocks = nn.ModuleList(
            [Block(c.dim, c.heads, c.mlp_ratio) for _ in range(c.depth)])
        self.norm = nn.LayerNorm(c.dim, eps=1e-6)

    def forward(self, img):
        c = self.cfg
        B = img.shape[0]
        y = self.patch_embed(img)
        h, w = y.shape[2:]
        x = torch.cat([self.cls_token.expand(B, -1, -1),
                       y.flatten(2).transpose(1, 2)], dim=1)
        x = x + resample_pos_embed(self.pos_embed[0], c.native_grid, h, w)
        outs = []
        want = set(c.layer_idx)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                z = self.norm(x)
                outs.append((z[:, 1:].transpose(1, 2).reshape(B, c.dim, h, w),
                             z[:, 0]))
        return outs
