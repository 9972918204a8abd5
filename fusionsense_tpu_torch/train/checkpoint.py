"""Checkpoint / resume in a torch format.

Counterpart of fusionsense_tpu/train/checkpoint.py (Orbax there). A
checkpoint is a directory holding `state.pt`: one torch.save of a nested
dict of plain tensors (gaussians, opt, stats, the camera optimiser) and the
step, loadable with weights_only=True. Beside the directory,
`<name>.meta.json` holds the host-side trainer state, with the JAX
package's keys (tile_capacity, cover_tiles, binary_opacities,
binary_opacity_threshold, history) plus render_n, so that a resumed run
rasterizes the same alive-first prefix as the uninterrupted one.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from fusionsense_tpu_torch.device import resolve_device
from fusionsense_tpu_torch.gaussians.adc import RefineStats
from fusionsense_tpu_torch.gaussians.store import GaussianState
from fusionsense_tpu_torch.train.optim import AdamState

STATE_FILE = "state.pt"


def _adam_tree(opt: AdamState) -> dict:
    return {"m": opt.m, "v": opt.v, "acc": opt.acc, "counts": opt.counts}


def _adam_from_tree(o: dict) -> AdamState:
    return AdamState(m=o["m"], v=o["v"], acc=o["acc"], counts=o["counts"])


def _meta_path(path: Path) -> Path:
    return path.parent / f"{path.name}.meta.json"


def save_checkpoint(path, gaussians: GaussianState, opt: AdamState,
                    stats: RefineStats, step: int,
                    extra: Optional[dict] = None, cam_state=None):
    """cam_state, when given, is the trainer's (deltas, AdamState) camera
    optimiser pair; `extra` goes to the meta.json sidecar."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tree = {"gaussians": gaussians.fields(), "opt": _adam_tree(opt),
            "stats": stats.fields(), "step": int(step)}
    if cam_state is not None:
        deltas, cam_opt = cam_state
        tree["cam"] = {"deltas": deltas, "opt": _adam_tree(cam_opt)}
    torch.save(tree, path / STATE_FILE)
    if extra is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(extra, f, indent=2, default=str)


def load_checkpoint_full(path, device=None):
    """Returns (gaussians, opt, stats, step, cam_state | None, meta | None)
    on `device` (the card unless given)."""
    path = Path(path).absolute()
    tree = torch.load(path / STATE_FILE, map_location=resolve_device(device),
                      weights_only=True)
    g = GaussianState(**tree["gaussians"])
    opt = _adam_from_tree(tree["opt"])
    stats = RefineStats(**tree["stats"])
    cam_state = None
    if "cam" in tree:
        cam_state = (tree["cam"]["deltas"], _adam_from_tree(tree["cam"]["opt"]))
    meta = None
    if _meta_path(path).exists():
        with open(_meta_path(path)) as f:
            meta = json.load(f)
    return g, opt, stats, int(tree["step"]), cam_state, meta


def load_checkpoint(path, device=None):
    """(gaussians, opt, stats, step)."""
    g, opt, stats, step, _, _ = load_checkpoint_full(path, device)
    return g, opt, stats, step


def load_for_inference(path, device=None):
    """Checkpoint -> (gaussians, step, cam_state) ready to render or export.

    Re-applies the binary-opacity snap when the checkpoint was trained with
    binary opacities (meta flag), so a checkpoint saved inside a reset
    margin still renders binarized; on snapped logits ({0, 1}) it is the
    identity."""
    g, _, _, step, cam_state, meta = load_checkpoint_full(path, device)
    if meta and meta.get("binary_opacities"):
        thr = float(meta.get("binary_opacity_threshold", 0.9))
        lo = g.logit_opacities
        g = g.replace(logit_opacities=(lo >= thr).to(lo.dtype))
    return g, step, cam_state


def save_trainer_state(trainer, path):
    """Trainer.save: the full state and the host policy state."""
    save_checkpoint(
        path, trainer.gaussians, trainer.opt, trainer.stats, trainer.step,
        cam_state=trainer.cam_state,
        extra={"tile_capacity": trainer.tile_capacity,
               "cover_tiles": trainer.cover_tiles,
               "binary_opacities": trainer.cfg.model.binary_opacities,
               "binary_opacity_threshold":
                   trainer.cfg.model.binary_opacity_threshold,
               "history": trainer.history[-5:],
               "render_n": trainer.render_n})


def restore_trainer_state(trainer, path):
    """Load model, optimiser, stats, step, camera optimiser and the host
    policy state into `trainer`; the caller recompacts."""
    g, opt, stats, step, cam_state, meta = load_checkpoint_full(
        path, trainer.device)
    if g.capacity > trainer.max_capacity:
        raise ValueError(f"checkpoint capacity {g.capacity} exceeds the "
                         f"configured max {trainer.max_capacity}")
    trainer.gaussians, trainer.opt, trainer.stats = g, opt, stats
    trainer.step = step
    if cam_state is not None:
        nv = cam_state[0].shape[0]
        if nv != trainer.num_views:
            raise ValueError(f"checkpoint has {nv} camera deltas, the scene "
                             f"has {trainer.num_views} views")
        trainer.cam_state = cam_state
    if meta:
        if meta.get("tile_capacity"):
            trainer.tile_capacity = int(meta["tile_capacity"])
        if meta.get("cover_tiles"):
            trainer.cover_tiles = int(meta["cover_tiles"])
        if meta.get("render_n"):
            trainer.render_n = int(meta["render_n"])
    return trainer
