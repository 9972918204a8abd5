"""VLDyHead: the fused vision-language dynamic head, on (C, h, w) maps.

Counterpart of fusionsense_tpu/detection/head.py, with the published
checkpoint's module names (reference PartSlip/GLIP/maskrcnn_benchmark/
modeling/rpn/vldyhead.py:141-233 DyConv, :560-859 VLDyHead):
`dyhead_tower` holds NUM_CONVS x [VLFuse, BertLayer (clamped), DyConv];
DyConv's branches are DyConv.0 (up: the coarser level, upsampled with
align_corners=True), DyConv.1 (same level) and DyConv.2 (down: the finer
level at stride 2), each a modulated deformable 3x3 + GroupNorm, fused by
the spatial attention `AttnConv` and a DyReLU `relu`. Then the bbox and
centerness 1x1 heads with per-level Scale and the dot-product token head
(normalised language embedding, /2 projection, language bias, log-scale
temperature), logits clamped to +-50,000.

The reference computes deformable offsets once per level and applies them
to the stride-1 conv of the coarser level, whose output is smaller: its
CUDA im2col reads the offset buffer as if it were (18, h', w'), i.e. the
row-major PREFIX of each (H, W) channel plane. The published weights were
trained under that reading, so `_reinterpret_plane` reproduces it.
"""
from __future__ import annotations

import torch
from torch import nn

from fusionsense_tpu_torch.detection.bert import (
    BertConfig, BertLayer, attention_bias,
)
from fusionsense_tpu_torch.detection.fusion import VLFuse
from fusionsense_tpu_torch.detection.layers import (
    Conv3x3Norm, DyReLU, HSigmoid, Scale,
)

NUM_CONVS = 8
CHANNELS = 256
LOG_SCALE_INIT = 0.0
PRIOR_BIAS = -4.59511985013459   # -log((1-0.01)/0.01), focal prior
CLAMP = 50000.0


def _upsample_bilinear_ac(x, h, w):
    """Bilinear upsample of (C, ih, iw) with align_corners=True (torch
    F.upsample_bilinear semantics, used at vldyhead.py:210), in the JAX
    package's order of operations."""
    ih, iw = x.shape[1:]

    def axis_interp(n_in, n_out):
        if n_in == 1:
            z = torch.zeros(n_out, dtype=torch.int64, device=x.device)
            return z, z, torch.zeros(n_out, device=x.device)
        c = torch.arange(n_out, device=x.device) * (n_in - 1) / (n_out - 1)
        lo = torch.clamp(torch.floor(c).to(torch.int64), 0, n_in - 2)
        return lo, lo + 1, c - lo

    y0, y1, fy = axis_interp(ih, h)
    x0, x1, fx = axis_interp(iw, w)
    fx = fx[None, None, :]
    top = x[:, y0][:, :, x0] * (1 - fx) + x[:, y0][:, :, x1] * fx
    bot = x[:, y1][:, :, x0] * (1 - fx) + x[:, y1][:, :, x1] * fx
    return top * (1 - fy[None, :, None]) + bot * fy[None, :, None]


def _reinterpret_plane(t, h, w):
    """Read (C, H, W) as the row-major prefix of each channel plane
    reshaped to (h, w) — the reference CUDA kernel's view of a
    current-level offset buffer applied at a coarser level."""
    return t.reshape(t.shape[0], -1)[:, :h * w].reshape(t.shape[0], h, w)


class DyConv(nn.Module):
    """One dynamic conv stage over the 5-level pyramid."""

    def __init__(self, channels: int = CHANNELS):
        super().__init__()
        c = channels
        self.DyConv = nn.ModuleList([
            Conv3x3Norm(c, c, 1),     # up
            Conv3x3Norm(c, c, 1),     # same level
            Conv3x3Norm(c, c, 2)])    # down
        self.AttnConv = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                      nn.Conv2d(c, 1, 1), nn.ReLU(),
                                      HSigmoid())
        self.relu = DyReLU(c)
        self.offset = nn.Conv2d(c, 27, 3, 1, 1)

    def forward(self, feats):
        n = len(feats)
        conv_up, conv_mid, conv_down = self.DyConv
        out = []
        for lv, f in enumerate(feats):
            # offsets and masks at this level's own resolution
            om = self.offset(f)
            o, m = om[:18], torch.sigmoid(om[18:])
            branches = [conv_mid(f, o, m)]
            if lv > 0:
                branches.append(conv_down(feats[lv - 1], o, m))
            if lv < n - 1:
                hc, wc = feats[lv + 1].shape[1:]
                up = conv_up(feats[lv + 1], _reinterpret_plane(o, hc, wc),
                             _reinterpret_plane(m, hc, wc))
                branches.append(_upsample_bilinear_ac(up, *f.shape[1:]))
            # spatial pyramid attention fusion (vldyhead.py:214-224)
            attns = [self.AttnConv(b) for b in branches]
            fused = sum(b * a for b, a in zip(branches, attns)) / len(branches)
            out.append(self.relu(fused))
        return out


class VLDyHead(nn.Module):
    """Tower + prediction heads. Returns per-level (bbox, ctr, dot_logits)."""

    def __init__(self, bert_cfg: BertConfig = BertConfig(),
                 channels: int = CHANNELS, num_convs: int = NUM_CONVS,
                 fuse_embed: int = 2048):
        super().__init__()
        tower = []
        for _ in range(num_convs):
            tower += [VLFuse(channels, bert_cfg.hidden, fuse_embed),
                      BertLayer(bert_cfg, clamp=CLAMP), DyConv(channels)]
        self.dyhead_tower = nn.ModuleList(tower)
        self.bbox_pred = nn.Conv2d(channels, 4, 1)
        self.centerness = nn.Conv2d(channels, 1, 1)
        self.scales = nn.ModuleList(Scale() for _ in range(5))
        self.dot_product_projection_text = nn.Linear(bert_cfg.hidden, channels)
        self.log_scale = nn.Parameter(torch.full((1,), LOG_SCALE_INIT))
        self.bias_lang = nn.Parameter(torch.zeros(bert_cfg.hidden))
        self.bias0 = nn.Parameter(torch.full((1,), PRIOR_BIAS))

    def forward(self, feats, lang, l_mask):
        attn_bias = attention_bias(l_mask)
        t = self.dyhead_tower
        for i in range(0, len(t), 3):
            feats, lang = t[i](feats, lang, l_mask)
            lang = t[i + 1](lang, attn_bias)
            feats = t[i + 2](feats)

        # dot-product token head (vldyhead.py:765-847)
        emb = lang / torch.clamp_min(
            torch.linalg.vector_norm(lang, dim=-1, keepdim=True), 1e-12)
        proj_tokens = self.dot_product_projection_text(emb / 2.0)  # (T, C)
        tok_bias = emb @ self.bias_lang + self.bias0               # (T,)
        out = []
        for lv, f in enumerate(feats):
            bbox = self.scales[lv](self.bbox_pred(f))              # (4, H, W)
            ctr = self.centerness(f)                               # (1, H, W)
            q = f.flatten(1).T                                     # (HW, C)
            dot = q @ proj_tokens.T / torch.exp(self.log_scale) + tok_bias[None]
            dot = torch.clamp(dot, -CLAMP, CLAMP)                  # (HW, T)
            out.append((bbox.flatten(1).T, ctr.reshape(-1), dot))
        return out
