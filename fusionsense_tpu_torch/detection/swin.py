"""Swin Transformer backbone of the grounded detector (one image).

Counterpart of fusionsense_tpu/detection/swin.py, with the published
checkpoint's module names (reference PartSlip/GLIP/maskrcnn_benchmark/
modeling/backbone/swint.py:431-646): patch-embed conv 4x4/4 + LayerNorm,
4 stages of shifted-window attention blocks with relative position bias,
PatchMerging between stages, output LayerNorms norm1..norm3 for the stages
the FPN reads (strides 8/16/32). Swin-L: embed 192, depths (2, 2, 18, 2),
heads (6, 12, 24, 48), window 12. Tokens are (H*W, C), row-major; the
outputs are (C, h, w) maps. The relative position index and the shifted
window mask are made here, not loaded (the published file's buffers of
those names are skipped by the loader).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 192
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (6, 12, 24, 48)
    window: int = 12
    mlp_ratio: float = 4.0
    out_indices: tuple = (1, 2, 3)   # FPN consumes strides 8/16/32


def _relative_position_index(w: int) -> np.ndarray:
    """(w*w, w*w) lookup into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def _shift_attn_mask(H: int, W: int, w: int, shift: int) -> np.ndarray:
    """(nW, w*w, w*w) additive mask for shifted windows (-100 blocked)."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(H // w, w, W // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _shift_mask_on(H: int, W: int, w: int, shift: int, device: torch.device):
    return torch.from_numpy(_shift_attn_mask(H, W, w, shift)).to(device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.dim, self.heads, self.window = dim, heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_position_index(window).reshape(-1)), persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask):        # x: (nW, N, C); mask (nW, N, N)|None
        h = self.heads
        N = self.window * self.window
        hd = self.dim // h
        bias = self.relative_position_bias_table[self.rel_index].reshape(
            N, N, h).permute(2, 0, 1)
        qkv = self.qkv(x).reshape(-1, N, 3, h, hd)
        q = qkv[:, :, 0].transpose(1, 2) * (hd ** -0.5)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        attn = q @ k.transpose(2, 3) + bias[None]
        if mask is not None:
            attn = attn + mask[:, None, :, :]
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(-1, N, self.dim)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.dim, self.window, self.shift = dim, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, H, W):        # x: (H*W, C)
        w, s, C = self.window, self.shift, self.dim
        shortcut = x
        x = self.norm1(x).reshape(H, W, C)
        Hp = int(math.ceil(H / w)) * w
        Wp = int(math.ceil(W / w)) * w
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(0, 1))
            mask = _shift_mask_on(Hp, Wp, w, s, x.device)
        else:
            mask = None
        xw = x.reshape(Hp // w, w, Wp // w, w, C).permute(0, 2, 1, 3, 4)
        xw = self.attn(xw.reshape(-1, w * w, C), mask)
        x = xw.reshape(Hp // w, Wp // w, w, w, C).permute(0, 2, 1, 3, 4)
        x = x.reshape(Hp, Wp, C)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(0, 1))
        x = x[:H, :W].reshape(H * W, C)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):       # (H*W, C) -> (ceil(H/2)*ceil(W/2), 2C)
        x = x.reshape(H, W, self.dim)
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[0::2, 0::2], x[1::2, 0::2],
                       x[0::2, 1::2], x[1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(-1, 4 * self.dim)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 4, 4)
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if b % 2 == 0 else window // 2,
                      mlp_ratio) for b in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig = SwinConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = PatchEmbed(c.embed_dim)
        self.layers = nn.ModuleList(
            SwinStage(c.embed_dim * 2 ** i, d, c.num_heads[i], c.window,
                      c.mlp_ratio, i < len(c.depths) - 1)
            for i, d in enumerate(c.depths))
        for i in c.out_indices:
            self.add_module(f"norm{i}",
                            nn.LayerNorm(c.embed_dim * 2 ** i, eps=1e-5))

    def forward(self, img):            # (3, H, W) -> list of (C_i, h, w)
        c = self.cfg
        H0, W0 = img.shape[1:]
        img = F.pad(img, (0, (-W0) % 4, 0, (-H0) % 4))
        x = self.patch_embed.proj(img)
        H, W = x.shape[1:]
        x = self.patch_embed.norm(x.reshape(c.embed_dim, H * W).T)
        outs = []
        dim = c.embed_dim
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, H, W)
            if i in c.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.T.reshape(dim, H, W))
            if stage.downsample is not None:
                x = stage.downsample(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
                dim *= 2
        return outs
