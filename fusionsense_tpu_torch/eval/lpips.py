"""LPIPS perceptual metric, weights-gated.

Counterpart of fusionsense_tpu/eval/lpips.py. Backends, in order:
1. the in-repo VGG-LPIPS (eval/lpips_vgg.py) with converted weights: the
   .npz at FUSIONSENSE_LPIPS_WEIGHTS, or ~/.cache/fusionsense/lpips_vgg.npz
   (the file the JAX package reads); a file that does not load, or whose
   shapes do not fit the net, is passed over for the next backend,
2. the `lpips` package if installed,
3. torchmetrics' LPIPS if installed,
4. else `available()` is False and the evaluator leaves the metric out.
"""
from __future__ import annotations

import os
import zipfile
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


def _load_vgg(path: str):
    """The in-repo net from `path`, run once on a small pair so a file of
    the wrong layout fails here; None when it does not load."""
    from fusionsense_tpu_torch.eval.lpips_vgg import LPIPSVGG, load_lpips_params

    try:
        net = LPIPSVGG(load_lpips_params(path))
        z = torch.zeros((16, 16, 3))
        with torch.no_grad():
            float(net(z, z))
    except (OSError, EOFError, ValueError, KeyError, RuntimeError, TypeError,
            zipfile.BadZipFile):
        return None
    return net


def available() -> bool:
    global _net, _kind
    if _kind is not None:
        return True
    path = _weights_path()
    if path is not None:
        net = _load_vgg(path)
        if net is not None:
            _net, _kind = net, "vgg"
            return True
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
    no backend is available. The in-repo net runs on the device of `pred`
    (the host for numpy); the package backends on the host."""
    if not available():
        return None

    if _kind == "vgg":
        dev = pred.device if torch.is_tensor(pred) else torch.device("cpu")
        as_t = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
            device=dev)
        with torch.no_grad():
            return float(_net.to(dev)(as_t(pred), as_t(gt)))

    def prep(x):
        x = x.detach().cpu() if torch.is_tensor(x) else torch.from_numpy(
            np.asarray(x, np.float32))
        return x.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0

    with torch.no_grad():
        return float(_net(prep(pred), prep(gt)))
