"""Foundation-model prior interfaces: monocular depth / normals / masks.

Counterpart of fusionsense_tpu/priors/mono_priors.py. The reference drives
external model families as offline preprocessing (SURVEY.md §2.3):
Metric3D v2 for metric depth and normals (torch.hub, utils/
metric3dv2_depth_generation.py), DSINE/omnidata for normals
(dn_splatter/scripts/normals_from_pretrain.py), Grounded-SAM2 for masks.
They produce priors; the reconstruction never backprops into them.

Here: a Protocol per modality, the file-layout writer `generate_priors`,
the in-repo predictors behind `default_normal_model` (DSINE or omnidata)
and `default_depth_model` (Metric3D, else Depth-Anything), the gated
`TorchHubDepthModel`, and the fallbacks that derive priors from the
capture itself (`DepthFromSensor`, `NormalsFromDepth`; the reference's
normals-from-depth mode, normals_from_pretrain.py:412).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Protocol

import numpy as np


class DepthModel(Protocol):
    def predict_depth(self, rgb: np.ndarray, fx: float) -> np.ndarray: ...


class NormalModel(Protocol):
    def predict_normals(self, rgb: np.ndarray) -> np.ndarray: ...


class MaskModel(Protocol):
    def predict_mask(self, rgb: np.ndarray, text: str) -> np.ndarray: ...


@dataclasses.dataclass
class TorchHubDepthModel:
    """Metric3D-style torch.hub metric depth (reference
    metric3dv2_depth_generation.py:78-82 vit_giant2 / vit_small by VRAM).

    Canonical-focal rescaling per the Metric3D convention: the net predicts
    at a 1000-unit canonical focal; outputs scale by fx/1000. Loading needs
    the hub's weights over the network."""

    hub_repo: str = "yvanyin/metric3d"
    model_name: str = "metric3d_vit_small"
    canonical_focal: float = 1000.0
    _model: object = None

    def _load(self):
        if self._model is None:
            import torch

            self._model = torch.hub.load(self.hub_repo, self.model_name,
                                         pretrain=True).eval()
        return self._model

    def predict_depth(self, rgb: np.ndarray, fx: float) -> np.ndarray:
        import torch

        model = self._load()
        x = torch.from_numpy(rgb.transpose(2, 0, 1))[None].float()
        with torch.no_grad():
            depth, *_ = model.inference({"input": x})
        return np.asarray(depth[0, 0]) * (fx / self.canonical_focal)


@dataclasses.dataclass
class DepthFromSensor:
    """Identity provider: the capture's own sensor depth as the mono prior."""

    def predict_depth(self, rgb, fx, sensor_depth=None):
        assert sensor_depth is not None
        return np.asarray(sensor_depth)


@dataclasses.dataclass
class NormalsFromDepth:
    """Normal maps from a depth map + intrinsics (the reference's
    normals-from-depth mode), computed on `device` (the card by default).
    Works with sensor or predicted depth."""

    device: Optional[str] = None

    def predict_normals_from_depth(self, depth: np.ndarray, fx, fy, cx, cy
                                   ) -> np.ndarray:
        import torch

        from fusionsense_tpu_torch.core.cameras import make_camera
        from fusionsense_tpu_torch.device import resolve_device
        from fusionsense_tpu_torch.train.losses import normals_from_depth

        dev = resolve_device(self.device)
        h, w = depth.shape
        cam = make_camera(np.eye(4, dtype=np.float32), fx, fy, cx, cy, w, h,
                          device=dev)
        d = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
        return normals_from_depth(d, cam).cpu().numpy()


def default_normal_model(checkpoint: str | Path | None = None,
                         model_type: str = "dsine",
                         resolution: str = "low", device=None):
    """The normal prior for `--model-type {omnidata, dsine}` (reference
    normals_from_pretrain.py:60-63; the orchestrator's default is DSINE,
    scripts/train.py:101), with omnidata's `--resolution {low, hd}`: the
    in-repo predictor on `device` when a checkpoint is found (the path
    argument, else $DSINE_CHECKPOINT or $OMNIDATA_CHECKPOINT), else None
    (generate_priors then falls back to normals from depth)."""
    import os

    if model_type == "omnidata":
        path = checkpoint or os.environ.get("OMNIDATA_CHECKPOINT")
        if not path or not Path(path).exists():
            return None
        from fusionsense_tpu_torch.priors.omnidata import OmnidataPredictor

        return OmnidataPredictor.from_checkpoint(
            str(path), resolution=resolution, device=device)

    path = checkpoint or os.environ.get("DSINE_CHECKPOINT")
    if not path or not Path(path).exists():
        return None
    from fusionsense_tpu_torch.priors.dsine import DSinePredictor

    return DSinePredictor.from_checkpoint(str(path), device=device)


def default_depth_model(checkpoint: str | Path | None = None,
                        model_type: str = "metric3d", device=None):
    """The in-repo mono-depth generators. The orchestrator's default is
    Metric3D v2 (reference utils/metric3dv2_depth_generation.py:79-81); the
    dn_splatter scripts path uses a hub depth net (depth_from_pretrain.py
    :44), which Depth-Anything fills. Returns the predictor on `device`
    when a checkpoint is found (the path argument, $METRIC3D_CHECKPOINT,
    or $DEPTH_ANYTHING_CHECKPOINT), else falls back to the other model
    type, else None."""
    import os

    if model_type == "metric3d":
        path = checkpoint or os.environ.get("METRIC3D_CHECKPOINT")
        if path and Path(path).exists():
            from fusionsense_tpu_torch.priors.metric3d import Metric3DPredictor

            return Metric3DPredictor.from_checkpoint(str(path), device=device)
        if checkpoint:       # explicit path that doesn't exist
            return None

    path = (None if model_type == "metric3d" else checkpoint) \
        or os.environ.get("DEPTH_ANYTHING_CHECKPOINT")
    if not path or not Path(path).exists():
        return None
    from fusionsense_tpu_torch.priors.depth_anything import DepthAnythingModel

    return DepthAnythingModel.from_checkpoint(str(path), device=device)


def generate_priors(
    scene_dir,
    depth_model: DepthModel | None = None,
    normal_model: NormalModel | None = None,
    overwrite: bool = False,
    device=None,
):
    """Produce mono-depth/normal artifacts for every frame of a scene and
    patch transforms.json to point at them (the file contract the reference
    orchestrator builds in steps 3/5, scripts/train.py:82-103). Normals
    from depth, where no normal model is given, are computed on `device`
    (the card by default)."""
    import json

    from fusionsense_tpu_torch.data.dataparser import load_depth, load_rgb
    from fusionsense_tpu_torch.device import resolve_device

    nfd = NormalsFromDepth(device=resolve_device(device))
    scene_dir = Path(scene_dir)
    with open(scene_dir / "transforms.json") as f:
        meta = json.load(f)
    out_depth = scene_dir / "mono_depth"
    out_normal = scene_dir / "mono_normals"
    out_depth.mkdir(exist_ok=True)
    out_normal.mkdir(exist_ok=True)

    for fr in meta["frames"]:
        name = Path(fr["file_path"]).stem
        rgb = load_rgb(scene_dir / fr["file_path"])
        fx = fr.get("fl_x", meta.get("fl_x"))
        fy = fr.get("fl_y", meta.get("fl_y"))
        cx = fr.get("cx", meta.get("cx"))
        cy = fr.get("cy", meta.get("cy"))

        depth = None
        if depth_model is not None:
            depth = depth_model.predict_depth(rgb, fx)
        elif "depth_file_path" in fr:
            depth = load_depth(scene_dir / fr["depth_file_path"])
        if depth is not None:
            dp = out_depth / f"{name}.npy"
            if overwrite or not dp.exists():
                np.save(dp, depth.astype(np.float32))
            fr["mono_depth_file_path"] = str(dp.relative_to(scene_dir))

        if normal_model is not None:
            normals = normal_model.predict_normals(rgb)
        elif depth is not None:
            normals = nfd.predict_normals_from_depth(depth, fx, fy, cx, cy)
        else:
            continue
        npth = out_normal / f"{name}.npy"
        if overwrite or not npth.exists():
            np.save(npth, normals.astype(np.float32))
        # normals-from-depth are OpenCV camera frame
        fr["normal_file_path"] = str(npth.relative_to(scene_dir))

    with open(scene_dir / "transforms.json", "w") as f:
        json.dump(meta, f)
    return meta
