"""State carried across: dicts of numpy arrays -> the port's state objects.

Each dict holds the JAX package's field names (for example the fields of a
GaussianState fetched to the host), so a run of either package can be
continued or compared in the other. Imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.data.tactile import TouchPatch
from fusionsense_tpu_torch.device import resolve_device
from fusionsense_tpu_torch.gaussians.adc import RefineStats
from fusionsense_tpu_torch.gaussians.store import PARAM_KEYS, GaussianState
from fusionsense_tpu_torch.train.optim import AdamState
from fusionsense_tpu_torch.train.trainer import TrainData


def _t(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)   # copies: host arrays may be read-only


def state_from_numpy(d: dict, device=None) -> GaussianState:
    dev = resolve_device(device)
    fields = (*PARAM_KEYS, "alive", "frozen")
    return GaussianState(**{k: _t(d[k], dev) for k in fields})


def adam_from_numpy(d: dict, device=None) -> AdamState:
    """d = {"m": {...}, "v": {...}, "acc": {...}, "counts": {...}}."""
    dev = resolve_device(device)
    tree = lambda sub: {k: _t(v, dev) for k, v in sub.items()}  # noqa: E731
    return AdamState(m=tree(d["m"]), v=tree(d["v"]), acc=tree(d["acc"]),
                     counts={k: _t(np.asarray(v, np.int32), dev)
                             for k, v in d["counts"].items()})


def stats_from_numpy(d: dict, device=None) -> RefineStats:
    dev = resolve_device(device)
    return RefineStats(grad2d_acc=_t(d["grad2d_acc"], dev),
                       count=_t(np.asarray(d["count"], np.int32), dev),
                       max_radius=_t(d["max_radius"], dev))


def camera_from_numpy(d: dict, device=None) -> Camera:
    dev = resolve_device(device)
    return Camera(**{k: _t(d[k], dev) for k in ("viewmat", "fx", "fy", "cx", "cy")},
                  width=int(d["width"]), height=int(d["height"]))


def train_data_from_numpy(d: dict, device=None) -> TrainData:
    dev = resolve_device(device)
    return TrainData(**{k: (None if d.get(k) is None else _t(d[k], dev))
                        for k in ("images", "sensor_depths", "mono_depths",
                                  "normals", "masks")})


def cam_state_from_numpy(deltas, opt: dict, device=None):
    """The camera optimiser's (deltas (V, 6), AdamState); `opt` as in
    adam_from_numpy, keyed "cam_delta"."""
    return _t(deltas, resolve_device(device)), adam_from_numpy(opt, device)


def touch_patches_from_numpy(patches: list[dict]) -> list[TouchPatch]:
    """Touch patches given as dicts of the TouchPatch fields (numpy), as the
    port's TouchPatch objects."""
    return [TouchPatch(**{k: np.array(v) for k, v in p.items()})
            for p in patches]
