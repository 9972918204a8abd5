"""Detection ops in plain PyTorch: the grounded detector's NMS family, ROI
pooling, focal loss and the modulated deformable convolution.

Counterpart of fusionsense_tpu/ops/detection.py (the replacements of
GLIP's maskrcnn_benchmark._C), without torchvision. The semantics are the
JAX functions' own:
- nms / ml_nms: a fixed min(max_out, n)-step loop of argmax and IoU
  suppression, every step a device op (no host sync), -1-padded output;
  torch.argmax takes the first index at ties, as jnp.argmax does;
- soft_nms: linear / gaussian score decay;
- roi_align, roi_pool, deform_roi_pool: bilinear or max pooling per box;
- sigmoid_focal_loss;
- deform_conv2d: gathered bilinear taps (zero outside the map) and one
  matmul.
Feature maps are channel-first, (C, H, W), where the JAX functions take
(H, W, C); their outputs are channel-first too.
"""
from __future__ import annotations

import torch

_NEG_INF = float("-inf")


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) [x0 y0 x1 y1] -> (N, M) IoU."""
    area_a = (torch.clamp_min(a[:, 2] - a[:, 0], 0)
              * torch.clamp_min(a[:, 3] - a[:, 1], 0))
    area_b = (torch.clamp_min(b[:, 2] - b[:, 0], 0)
              * torch.clamp_min(b[:, 3] - b[:, 1], 0))
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_out: int = 100):
    """Greedy NMS. Returns (keep_idx (max_out,) int32, valid (max_out,))."""
    n = boxes.shape[0]
    dev = boxes.device
    iou = box_iou(boxes, boxes)
    ids = torch.arange(n, device=dev)
    alive = scores.to(torch.float32)
    keep = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros(max_out, dtype=torch.bool, device=dev)
    for i in range(min(max_out, n)):
        best = torch.argmax(alive).view(1)
        ok = alive.index_select(0, best) > _NEG_INF
        keep[i:i + 1] = torch.where(ok, best.to(torch.int32), -1)
        valid[i:i + 1] = ok
        # suppress the overlapping boxes and the chosen box itself
        suppress = (iou.index_select(0, best)[0] > iou_threshold) | (ids == best)
        alive = torch.where(ok & suppress, _NEG_INF, alive)
    return keep, valid


def ml_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
           iou_threshold: float = 0.5, max_out: int = 100):
    """Multi-label NMS: suppression only within the same class — boxes are
    offset per class so cross-class IoU is 0 (reference ml_nms.cu)."""
    extent = torch.max(boxes) - torch.min(boxes) + 1.0
    off = labels.to(torch.float32)[:, None] * extent
    return nms(boxes + off * torch.ones(1, 4, device=boxes.device), scores,
               iou_threshold, max_out)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, sigma: float = 0.5,
             iou_threshold: float = 0.3, score_threshold: float = 1e-3,
             method: str = "gaussian") -> torch.Tensor:
    """Soft-NMS (reference cpu/soft_nms.cpp): decay instead of suppression.
    Returns rescored scores (same order)."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    ids = torch.arange(n, device=boxes.device)
    cur = scores.to(torch.float32)
    processed = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for _ in range(n):
        masked = torch.where(processed, _NEG_INF, cur)
        best = torch.argmax(masked).view(1)
        ok = masked.index_select(0, best) > score_threshold
        ious = iou.index_select(0, best)[0]
        if method == "gaussian":
            decay = torch.exp(-(ious ** 2) / sigma)
        else:
            decay = torch.where(ious > iou_threshold, 1.0 - ious, 1.0)
        decay = torch.where(processed | (ids == best), 1.0, decay)
        cur = torch.where(ok, cur * decay, cur)
        processed = processed | (ids == best)
    return cur


def _gather_hw(feat: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """feat (C, H, W) at integer coords (...) -> (C, ...)."""
    W = feat.shape[2]
    flat = (yi * W + xi).reshape(-1)
    return feat.flatten(1).index_select(1, flat).reshape(
        feat.shape[0], *yi.shape)


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign (reference ROIAlign_cuda.cu): bilinear-sampled pooled crops.
    features (C, H, W); boxes (N, 4) in input coords. Returns
    (N, C, output_size, output_size)."""
    C, H, W = features.shape
    b = boxes * spatial_scale
    S = output_size * sampling_ratio
    dev = features.device
    ys = (torch.arange(S, device=dev) + 0.5) / S
    gy, gx = torch.meshgrid(ys, ys, indexing="ij")
    x0, y0, x1, y1 = (b[:, i, None, None] for i in range(4))
    px = x0 + gx * torch.clamp_min(x1 - x0, 1.0)                 # (N, S, S)
    py = y0 + gy * torch.clamp_min(y1 - y0, 1.0)
    x0i = torch.clamp(torch.floor(px - 0.5).to(torch.int64), 0, W - 1)
    y0i = torch.clamp(torch.floor(py - 0.5).to(torch.int64), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    fx = torch.clamp(px - 0.5 - x0i, 0.0, 1.0)
    fy = torch.clamp(py - 0.5 - y0i, 0.0, 1.0)
    v = (_gather_hw(features, y0i, x0i) * (1 - fx) * (1 - fy)
         + _gather_hw(features, y0i, x1i) * fx * (1 - fy)
         + _gather_hw(features, y1i, x0i) * (1 - fx) * fy
         + _gather_hw(features, y1i, x1i) * fx * fy)             # (C, N, S, S)
    v = v.reshape(C, -1, output_size, sampling_ratio, output_size,
                  sampling_ratio)
    return v.mean(dim=(3, 5)).transpose(0, 1)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss (reference SigmoidFocalLoss_cuda.cu)."""
    p = torch.sigmoid(logits)
    ce = (torch.clamp_min(logits, 0) - logits * targets
          + torch.log1p(torch.exp(-torch.abs(logits))))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


# ----------------------------------------------------- deformable ops ------

def _bilinear_sample(img: torch.Tensor, py: torch.Tensor,
                     px: torch.Tensor) -> torch.Tensor:
    """Sample (C, H, W) at float coords (...) -> (C, ...), zero where a tap
    falls outside the map."""
    _, H, W = img.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = py - y0
    fx = px - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = _gather_hw(img, torch.clamp(yi, 0, H - 1),
                       torch.clamp(xi, 0, W - 1))
        return torch.where(inside, v, 0.0)

    return (tap(y0i, x0i) * (1 - fy) * (1 - fx)
            + tap(y0i, x0i + 1) * (1 - fy) * fx
            + tap(y0i + 1, x0i) * fy * (1 - fx)
            + tap(y0i + 1, x0i + 1) * fy * fx)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None, stride: int = 1,
                  padding: int = 1, dilation: int = 1,
                  deformable_groups: int = 1) -> torch.Tensor:
    """Deformable convolution v1/v2 (reference deform_conv_cuda.cu:694 and
    the modulated variant): gathered bilinear taps and one matmul.

    x: (Cin, H, W) input feature map.
    offset: (dg*kh*kw*2, Ho, Wo) sample offsets, tap-major, (dy, dx)
        interleaved in torch's channel order (y first).
    weight: (Cout, Cin, kh, kw).
    mask: optional (dg*kh*kw, Ho, Wo) modulation (v2); None -> v1.
    Returns (Cout, Ho, Wo).
    """
    Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    Ho = (H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dg = deformable_groups
    cpg = Cin // dg
    dev = x.device

    oy = torch.arange(Ho, device=dev) * stride - padding
    ox = torch.arange(Wo, device=dev) * stride - padding
    kyy, kxx = torch.meshgrid(torch.arange(kh, device=dev) * dilation,
                              torch.arange(kw, device=dev) * dilation,
                              indexing="ij")
    # base sample positions, tap-major like the torch kernel: (K, Ho|1, Wo|1)
    base_y = (kyy.reshape(K)[:, None, None] + oy[None, :, None]).to(x.dtype)
    base_x = (kxx.reshape(K)[:, None, None] + ox[None, None, :]).to(x.dtype)

    off = offset.reshape(dg, K, 2, Ho, Wo)
    taps = []
    for g in range(dg):
        py = base_y + off[g, :, 0]
        px = base_x + off[g, :, 1]
        sg = _bilinear_sample(x[g * cpg:(g + 1) * cpg], py, px)  # (cpg, K, Ho, Wo)
        if mask is not None:
            sg = sg * mask.reshape(dg, K, Ho, Wo)[g][None]
        taps.append(sg)
    sampled = torch.cat(taps, dim=0) if dg > 1 else taps[0]
    # (Cout, Cin * K) x (Cin * K, Ho * Wo)
    out = weight.reshape(Cout, Cin * K) @ sampled.reshape(Cin * K, Ho * Wo)
    out = out.reshape(Cout, Ho, Wo)
    if bias is not None:
        out = out + bias[:, None, None]
    return out


def roi_pool(features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """ROIPool (reference ROIPool_cuda.cu:212): max-pool over quantized
    bins. features (C, H, W); boxes (N, 4). Returns (N, C, out, out)."""
    C, H, W = features.shape
    b = torch.round(boxes * spatial_scale)
    dev = features.device
    x0, y0, x1, y1 = (b[:, i, None] for i in range(4))
    rw = torch.clamp_min(x1 - x0 + 1.0, 1.0)
    rh = torch.clamp_min(y1 - y0 + 1.0, 1.0)
    # bin edges, quantized exactly like the CUDA kernel
    i = torch.arange(output_size, device=dev)
    ys = torch.clamp(torch.floor(y0 + i * rh / output_size), 0, H - 1)
    ye = torch.clamp(torch.ceil(y0 + (i + 1) * rh / output_size), 0, H)
    xs = torch.clamp(torch.floor(x0 + i * rw / output_size), 0, W - 1)
    xe = torch.clamp(torch.ceil(x0 + (i + 1) * rw / output_size), 0, W)
    gy = torch.arange(H, device=dev)
    gx = torch.arange(W, device=dev)
    my = (gy >= ys[..., None]) & (gy < ye[..., None])            # (N, out, H)
    mx = (gx >= xs[..., None]) & (gx < xe[..., None])            # (N, out, W)
    m = my[:, :, None, :, None] & mx[:, None, :, None, :]        # (N, o, o, H, W)
    vals = torch.where(m[:, None], features[None, :, None, None], _NEG_INF)
    out = torch.amax(vals, dim=(4, 5))                           # (N, C, o, o)
    return torch.where(torch.isfinite(out), out, 0.0)


def deform_roi_pool(features: torch.Tensor, boxes: torch.Tensor,
                    offsets: torch.Tensor, output_size: int = 7,
                    spatial_scale: float = 1.0, sampling_ratio: int = 2,
                    gamma: float = 0.1) -> torch.Tensor:
    """Deformable ROI pooling (reference deform_pool_cuda.cu:456): ROIAlign
    bins shifted by learned normalized offsets (gamma-scaled by box size).

    features (C, H, W); offsets: (N, output_size, output_size, 2)
    normalized (dy, dx). Returns (N, C, output_size, output_size)."""
    b = boxes * spatial_scale
    S = sampling_ratio
    dev = features.device
    x0, y0, x1, y1 = (b[:, i, None, None, None, None] for i in range(4))
    rw = torch.clamp_min(x1 - x0, 1.0)
    rh = torch.clamp_min(y1 - y0, 1.0)
    bw, bh = rw / output_size, rh / output_size
    i = torch.arange(output_size, device=dev)
    s = (torch.arange(S, device=dev) + 0.5) / S
    # per-bin sample grid + deform shift: (N, out, out, S, S)
    by = y0 + i[:, None, None, None] * bh + s[None, None, :, None] * bh
    bx = x0 + i[None, :, None, None] * bw + s[None, None, None, :] * bw
    by = by + offsets[..., 0, None, None] * gamma * rh
    bx = bx + offsets[..., 1, None, None] * gamma * rw
    shape = (boxes.shape[0], output_size, output_size, S, S)
    v = _bilinear_sample(features, by.expand(shape), bx.expand(shape))
    return v.mean(dim=(4, 5)).transpose(0, 1)

