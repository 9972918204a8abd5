"""DSINE: decoder + rotation-based neighbourhood refinement, in NCHW.

Counterpart of fusionsense_tpu/priors/dsine/model.py (the reference's
dn_splatter/scripts/dsine/dsine.py Decoder :20-69 and DSINE :72-300,
submodules.py UpSampleGN with weight-standardised convs :112-178, ConvGRU
:42-57, RayReLU :59-84, convex upsampling :205-218, prediction heads
:231-238). Parameter names are the published checkpoint's. The
refinement's per-neighbour geometry runs channels-last, (B, h, w, n, ...)
over the ps x ps patch, as the JAX package writes it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from fusionsense_tpu_torch.priors.dsine.efficientnet import (
    EffNetConfig, EfficientNet, stage_channels, tiny_effnet,
)
from fusionsense_tpu_torch.priors.resize import resize


def normalize(x, dim=-1, eps=1e-12):
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), eps)


class ConvWS(nn.Conv2d):
    """Weight-standardised 3x3 conv (submodules.py Conv2d_WS:112-149): the
    kernel minus its mean over (in, kh, kw), over its UNBIASED std + 1e-5."""

    def __init__(self, c_in, c_out):
        super().__init__(c_in, c_out, 3, padding=1)

    def forward(self, x):
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        mean = flat.mean(dim=1)
        std = flat.std(dim=1, unbiased=True) + 1e-5
        wn = (w - mean[:, None, None, None]) / std[:, None, None, None]
        return F.conv2d(x, wn, self.bias, padding=1)


class UpSampleGN(nn.Module):
    """Bilinear-upsample x to skip's size, concat, two WS-conv + GN(8) +
    LeakyReLU."""

    def __init__(self, c_in, features):
        super().__init__()
        self._net = nn.Sequential(
            ConvWS(c_in, features), nn.GroupNorm(8, features, eps=1e-5),
            nn.LeakyReLU(),
            ConvWS(features, features), nn.GroupNorm(8, features, eps=1e-5),
            nn.LeakyReLU())

    def forward(self, x, skip):
        up = resize(x, x.shape[:2] + skip.shape[2:], "bilinear")
        return self._net(torch.cat([up, skip], dim=1))


def prediction_head(c_in, hidden, out):
    """conv3x3 -> relu -> conv1x1 -> relu -> conv1x1 (submodules.py:231)."""
    return nn.Sequential(nn.Conv2d(c_in, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, hidden, 1), nn.ReLU(),
                         nn.Conv2d(hidden, out, 1))


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, c_in: int, ks: int = 5):
        super().__init__()
        p = (ks - 1) // 2
        self.convz = nn.Conv2d(hidden + c_in, hidden, ks, padding=p)
        self.convr = nn.Conv2d(hidden + c_in, hidden, ks, padding=p)
        self.convq = nn.Conv2d(hidden + c_in, hidden, ks, padding=p)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


def ray_relu(pred_norm, ray, eps=1e-2):
    """Clamp the normal's component along the ray to >= eps (channels
    last; submodules.py RayReLU:59-84)."""
    cos = torch.sum(pred_norm * ray, dim=-1, keepdim=True)
    return normalize(pred_norm + ray * (torch.clamp_min(cos, eps) - cos))


def unfold_patches(x, ps: int):
    """(B, C, H, W) -> (B, H, W, ps*ps, C) replicate-padded neighbourhoods,
    neighbour n = dy * ps + dx."""
    B, C, H, W = x.shape
    pad = (ps - 1) // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    cols = F.unfold(xp, ps)                       # (B, C * ps * ps, H * W)
    return cols.reshape(B, C, ps * ps, H, W).permute(0, 3, 4, 2, 1)


def convex_upsample(out, up_mask, k: int):
    """(B, C, H, W) low-res + (B, 9*k*k, H, W) mask -> (B, C, kH, kW)
    (submodules.py convex_upsampling:205-218, replicate-padded 3x3)."""
    B, C, H, W = out.shape
    m = torch.softmax(up_mask.reshape(B, 9, k, k, H, W), dim=1)
    nb = unfold_patches(out, 3)                   # (B, H, W, 9, C)
    up = torch.einsum("bnuvhw,bhwnc->bchuwv", m, nb)
    return up.reshape(B, C, H * k, W * k)


def axis_angle_to_matrix(axis_angle):
    """(..., 3) axis*angle -> (..., 3, 3) (rotations.py, PyTorch3D form)."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angle * 0.5
    small = torch.abs(angle) < 1e-6
    sin_over = torch.where(
        small, 0.5 - angle * angle / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    quat = torch.cat([torch.cos(half), axis_angle * sin_over], dim=-1)
    r, i, j, k = quat.unbind(-1)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(o.shape[:-1] + (3, 3))


@dataclasses.dataclass(frozen=True)
class DSINEConfig:
    effnet: EffNetConfig = EffNetConfig()
    nf: int = 2048
    feature_dim: int = 64
    hidden_dim: int = 64
    ps: int = 5
    num_iter: int = 5
    downsample: int = 8


def tiny_dsine() -> DSINEConfig:
    return DSINEConfig(effnet=tiny_effnet(), nf=32, feature_dim=8,
                       hidden_dim=8, num_iter=2)


def _intrinsics_at(K, h, w, H, W):
    """(fu, cu, fv, cv), each (B, 1, 1), of K scaled from (H, W) to (h, w)."""
    fu = K[:, 0, 0] * (w / W)
    cu = K[:, 0, 2] * (w / W)
    fv = K[:, 1, 1] * (h / H)
    cv = K[:, 1, 2] * (h / H)
    return tuple(v[:, None, None] for v in (fu, cu, fv, cv))


def uv_grid(K, h, w, H, W, normalized=False):
    """(B, h, w, 2) camera-plane (u, v) at pixel centres of an (h, w) grid
    of an (H, W) image (dsine.py get_ray:127-142); with `normalized`, the
    (B, h, w, 3) unit rays."""
    fu, cu, fv, cv = _intrinsics_at(K, h, w, H, W)
    xs = torch.arange(w, dtype=K.dtype, device=K.device) + 0.5
    ys = torch.arange(h, dtype=K.dtype, device=K.device) + 0.5
    u = ((xs[None, None, :] - cu) / fu).expand(-1, h, w)
    v = ((ys[None, :, None] - cv) / fv).expand(-1, h, w)
    uv = torch.stack([u, v], dim=-1)
    if not normalized:
        return uv
    return normalize(torch.cat([uv, torch.ones_like(u)[..., None]], dim=-1))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: EffNetConfig):
        super().__init__()
        self.original_model = EfficientNet(cfg)

    def forward(self, x):
        return self.original_model(x)


class Decoder(nn.Module):
    def __init__(self, cfg: DSINEConfig):
        super().__init__()
        ch = stage_channels(cfg.effnet)
        nf = cfg.nf
        self.conv2 = nn.Conv2d(ch["head"] + 2, nf, 1)
        self.up1 = UpSampleGN(nf + ch["s16"] + 2, nf // 2)
        self.up2 = UpSampleGN(nf // 2 + ch["s8"] + 2, nf // 4)
        c = nf // 4 + 2
        self.normal_head = prediction_head(c, 128, 3)
        self.feature_head = prediction_head(c, 128, cfg.feature_dim)
        self.hidden_head = prediction_head(c, 128, cfg.hidden_dim)


class DSINE(nn.Module):
    """(B, 3, H, W) image (ImageNet-normalised, H and W multiples of 32) +
    (B, 3, 3) intrinsics -> (B, 3, H, W) camera-space normals (the final
    refinement iteration)."""

    def __init__(self, cfg: DSINEConfig = DSINEConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        n = c.ps * c.ps
        self.encoder = Encoder(c.effnet)
        self.decoder = Decoder(c)
        self.gru = ConvGRU(c.hidden_dim, c.feature_dim + 2, c.ps)
        self.prob_head = prediction_head(c.hidden_dim + 2, 64, n)
        self.xy_head = prediction_head(c.hidden_dim + 2, 64, 2 * n)
        self.angle_head = prediction_head(c.hidden_dim + 2, 64, n)
        self.up_prob_head = prediction_head(c.hidden_dim + 2, 64,
                                            9 * c.downsample ** 2)

    def forward(self, img, K):
        c, d = self.cfg, self.decoder
        H, W = img.shape[2:]
        feats = self.encoder(img)

        # the reference predictor shifts the principal point by +0.5
        K = K.clone()
        K[:, 0, 2] += 0.5
        K[:, 1, 2] += 0.5
        uv32 = _nchw(uv_grid(K, H // 32, W // 32, H, W))
        uv16 = _nchw(uv_grid(K, H // 16, W // 16, H, W))
        uv8 = _nchw(uv_grid(K, H // 8, W // 8, H, W))
        ray8 = uv_grid(K, H // 8, W // 8, H, W, normalized=True)

        # ---- decoder (dsine.py:50-69) ----
        x_d0 = d.conv2(torch.cat([feats["head"], uv32], 1))
        x_d1 = d.up1(x_d0, torch.cat([feats["s16"], uv16], 1))
        x_feat = d.up2(x_d1, torch.cat([feats["s8"], uv8], 1))
        x_feat = torch.cat([x_feat, uv8], 1)

        pred_norm = normalize(d.normal_head(x_feat).permute(0, 2, 3, 1))
        pred_norm = ray_relu(pred_norm, ray8)            # (B, h, w, 3)
        feat_map = torch.cat([d.feature_head(x_feat), uv8], 1)
        h = d.hidden_head(x_feat)

        # ---- NRN refinement (dsine.py refine:150-264) ----
        B, _, h8, w8 = uv8.shape
        fu, cu, fv, cv = (v[..., None] for v in _intrinsics_at(K, h8, w8, H, W))
        xs = torch.arange(w8, dtype=img.dtype, device=img.device) + 0.5
        ys = torch.arange(h8, dtype=img.dtype, device=img.device) + 0.5
        pix = torch.stack([xs[None, :].expand(h8, w8),
                           ys[:, None].expand(h8, w8)])[None]
        nghbr_pix = unfold_patches(pix, c.ps)            # (1, h, w, n, 2)
        n = c.ps * c.ps
        for _ in range(c.num_iter):
            h = self.gru(h, feat_map)
            hx = torch.cat([h, uv8], 1)
            prob = torch.sigmoid(self.prob_head(hx)).permute(0, 2, 3, 1)
            nghbr_n = unfold_patches(_nchw(pred_norm.detach()), c.ps)
            xy = self.xy_head(hx).permute(0, 2, 3, 1)    # (B, h, w, 2n)
            xys = normalize(torch.stack([xy[..., :n], xy[..., n:]], -1))
            ang = torch.sigmoid(self.angle_head(hx)).permute(0, 2, 3, 1) \
                * math.pi                                # (B, h, w, n)

            du_fu = xys[..., 0] / fu
            dv_fv = xys[..., 1] / fv
            term_u = (nghbr_pix[..., 0] + xys[..., 0] - cu) / fu
            term_v = (nghbr_pix[..., 1] + xys[..., 1] - cv) / fv
            nx, ny, nz = nghbr_n.unbind(-1)
            num = -(du_fu * nx + dv_fv * ny)
            den = term_u * nx + term_v * ny + nz
            den = torch.where(torch.abs(den) < 1e-8,
                              1e-8 * torch.sign(den + 1e-30), den)
            dz = num / den
            axes = normalize(torch.stack(
                [du_fu + dz * term_u, dv_fv + dz * term_v, dz], -1))
            axes = torch.where(torch.isfinite(axes).all(-1, keepdim=True),
                               axes, torch.zeros_like(axes))
            R = axis_angle_to_matrix(axes * ang[..., None])
            rot = normalize(torch.einsum("...ij,...j->...i", R, nghbr_n))
            rot = ray_relu(rot, ray8[:, :, :, None, :])
            pred_norm = normalize(torch.sum(prob[..., None] * rot, dim=3))

        up_mask = self.up_prob_head(torch.cat([h, uv8], 1))
        up = convex_upsample(_nchw(pred_norm), up_mask, c.downsample)
        return normalize(up, dim=1)
