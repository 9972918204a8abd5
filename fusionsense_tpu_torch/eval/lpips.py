"""LPIPS perceptual metric, weights-gated.

Counterpart of fusionsense_tpu/eval/lpips.py. Backends, in order:
1. the in-repo VGG-LPIPS with converted weights (FUSIONSENSE_LPIPS_WEIGHTS,
   or ~/.cache/fusionsense/lpips_vgg.npz): not ported yet, so a weights file
   found there raises NotImplementedError (ROADMAP A14) rather than being
   passed over,
2. the `lpips` package if installed,
3. torchmetrics' LPIPS if installed,
4. else `available()` is False and the evaluator leaves the metric out.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

_net = None
_kind = None


def _weights_path() -> str | None:
    p = os.environ.get("FUSIONSENSE_LPIPS_WEIGHTS")
    if p and Path(p).exists():
        return p
    default = Path.home() / ".cache" / "fusionsense" / "lpips_vgg.npz"
    return str(default) if default.exists() else None


def available() -> bool:
    global _net, _kind
    if _kind is not None:
        return True
    path = _weights_path()
    if path is not None:
        raise NotImplementedError(
            f"LPIPS weights at {path}: the in-repo VGG-LPIPS net is not "
            "ported (ROADMAP A14)")
    try:
        import lpips as _lpips  # type: ignore

        _net = _lpips.LPIPS(net="vgg")
        _kind = "lpips"
        return True
    except Exception:
        pass
    try:
        from torchmetrics.image.lpip import (  # type: ignore
            LearnedPerceptualImagePatchSimilarity,
        )

        _net = LearnedPerceptualImagePatchSimilarity(net_type="vgg")
        _kind = "torchmetrics"
        return True
    except Exception:
        return False


def lpips(pred, gt) -> float | None:
    """(H, W, 3) pair in [0, 1] (numpy or tensors) -> LPIPS, or None when
    no backend is available. The net runs on the host."""
    if not available():
        return None

    def prep(x):
        x = x.detach().cpu() if torch.is_tensor(x) else torch.from_numpy(
            np.asarray(x, np.float32))
        return x.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0

    with torch.no_grad():
        return float(_net(prep(pred), prep(gt)))
