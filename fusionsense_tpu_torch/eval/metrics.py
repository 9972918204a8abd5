"""Evaluation metrics: RGB / depth / normal / point cloud.

Counterpart of fusionsense_tpu/eval/metrics.py:
- PSNR, SSIM (train/losses.ssim) and the masked PSNR (MSE over the mask
  area times the channels),
- depth: abs_rel, sq_rel, rmse, rmse_log, a1/a2/a3 over pixels whose GT
  depth exceeds the 0.1 tolerance (and the mask, when given),
- normals: mean angular error, RMSE, mean and median (the median of an even
  count averages the two middle values, as jnp.nanmedian does),
- point clouds: accuracy (90th-percentile NN distance), completeness and the
  symmetric chamfer, on the host with scipy's cKDTree.
The image metrics return 0-d tensors on the inputs' device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fusionsense_tpu_torch.train.losses import ssim


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.mean((pred - gt) ** 2) + 1e-12)


def masked_psnr(pred: torch.Tensor, gt: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None] if mask.dim() == pred.dim() - 1 else mask
    se = torch.sum(((pred - gt) * m) ** 2)
    denom = torch.clamp_min(torch.sum(m) * pred.shape[-1], 1.0)
    return -10.0 * torch.log10(se / denom + 1e-12)


def rgb_metrics(pred, gt, mask=None) -> dict:
    out = {"psnr": psnr(pred, gt), "ssim": ssim(pred, gt)}
    if mask is not None:
        out["masked_psnr"] = masked_psnr(pred, gt, mask)
    return out


def depth_metrics(pred: torch.Tensor, gt: torch.Tensor,
                  tolerance: float = 0.1, mask=None) -> dict:
    """The monodepth battery over valid (gt > tolerance, and in the mask
    when one is given) pixels."""
    valid = gt > tolerance
    if mask is not None:
        valid = valid & (mask > 0.5)
    n = torch.clamp_min(torch.sum(valid), 1)
    one = torch.ones_like(pred)
    p = torch.clamp_min(torch.where(valid, pred, one), 1e-6)
    g = torch.where(valid, gt, one)
    err = p - g
    mmean = lambda x: torch.sum(torch.where(  # noqa: E731
        valid, x, torch.zeros_like(x))) / n
    thresh = torch.maximum(p / g, g / p)
    return {
        "abs_rel": mmean(torch.abs(err) / g),
        "sq_rel": mmean(err * err / g),
        "rmse": torch.sqrt(mmean(err * err)),
        "rmse_log": torch.sqrt(mmean((torch.log(p) - torch.log(g)) ** 2)),
        "a1": mmean((thresh < 1.25).to(torch.float32)),
        "a2": mmean((thresh < 1.25 ** 2).to(torch.float32)),
        "a3": mmean((thresh < 1.25 ** 3).to(torch.float32)),
    }


def angular_error_deg(pred_n: torch.Tensor, gt_n: torch.Tensor) -> torch.Tensor:
    """Per-pixel angle in degrees between the unit-normalised normals."""
    pn = pred_n / torch.clamp_min(
        torch.linalg.norm(pred_n, dim=-1, keepdim=True), 1e-8)
    gn = gt_n / torch.clamp_min(
        torch.linalg.norm(gt_n, dim=-1, keepdim=True), 1e-8)
    cos = torch.clamp(torch.sum(pn * gn, -1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def normal_metrics(pred_n, gt_n, mask=None) -> dict:
    ang = angular_error_deg(pred_n, gt_n)
    mask = torch.ones_like(ang) if mask is None else mask.to(ang.dtype)
    n = torch.clamp_min(torch.sum(mask), 1)
    mean = torch.sum(ang * mask) / n
    rmse = torch.sqrt(torch.sum(ang * ang * mask) / n)
    # nanquantile's linear rule at 0.5 is the two-middle average
    med = torch.nanquantile(torch.where(mask > 0, ang, math.nan).reshape(-1),
                            0.5)
    return {"mae": mean, "rmse": rmse, "mean": mean, "median": med}


def pd_metrics(pred_points: np.ndarray, gt_points: np.ndarray,
               comp_threshold: float = 0.05) -> dict:
    """Point-cloud accuracy (90th-percentile pred -> gt NN distance) and
    completeness (fraction of gt within comp_threshold)."""
    from scipy.spatial import cKDTree

    d_pred, _ = cKDTree(np.asarray(gt_points)).query(np.asarray(pred_points))
    d_gt, _ = cKDTree(np.asarray(pred_points)).query(np.asarray(gt_points))
    return {"accuracy_p90": float(np.percentile(d_pred, 90)),
            "completeness": float(np.mean(d_gt < comp_threshold))}


def chamfer_distance(a: np.ndarray, b: np.ndarray, scale: float = 1e3) -> float:
    """Symmetric squared chamfer x 1e3."""
    from scipy.spatial import cKDTree

    da, _ = cKDTree(np.asarray(b)).query(np.asarray(a))
    db, _ = cKDTree(np.asarray(a)).query(np.asarray(b))
    return float((np.mean(da ** 2) + np.mean(db ** 2)) * scale)
