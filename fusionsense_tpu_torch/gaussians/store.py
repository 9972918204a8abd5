"""Padded, statically-shaped Gaussian parameter store.

Counterpart of fusionsense_tpu/gaussians/store.py: a fixed-capacity set of
float32 tensors with `alive` and `frozen` masks, so densify/cull/compaction
are masked writes and permutations rather than reshapes.
"""
from __future__ import annotations

import dataclasses

import torch

from fusionsense_tpu_torch.core.sh import num_sh_bases
from fusionsense_tpu_torch.device import resolve_device

PARAM_KEYS = (
    "means", "quats", "log_scales", "logit_opacities",
    "features_dc", "features_rest", "normals",
)


@dataclasses.dataclass
class GaussianState:
    """All fields share leading dim = capacity."""

    means: torch.Tensor            # (C, 3)
    quats: torch.Tensor            # (C, 4) wxyz, unnormalized
    log_scales: torch.Tensor       # (C, 3)
    logit_opacities: torch.Tensor  # (C,)
    features_dc: torch.Tensor      # (C, 3) SH degree-0
    features_rest: torch.Tensor    # (C, K-1, 3) higher SH bands
    normals: torch.Tensor          # (C, 3) explicit normals (touch targets)
    alive: torch.Tensor            # (C,) bool
    frozen: torch.Tensor           # (C,) bool, touch-anchored geometry

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)


def new_state(capacity: int, sh_degree: int = 3, device=None) -> GaussianState:
    dev = resolve_device(device)
    K = num_sh_bases(sh_degree)
    f32 = dict(dtype=torch.float32, device=dev)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    normals = torch.zeros((capacity, 3), **f32)
    normals[:, 2] = 1.0
    return GaussianState(
        means=torch.zeros((capacity, 3), **f32),
        quats=quats,
        log_scales=torch.full((capacity, 3), -5.0, **f32),
        logit_opacities=torch.full((capacity,), -10.0, **f32),
        features_dc=torch.zeros((capacity, 3), **f32),
        features_rest=torch.zeros((capacity, K - 1, 3), **f32),
        normals=normals,
        alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        frozen=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def surgery_due(step: int, *, warmup: int, skip: int, margin: int = 200) -> bool:
    """Whether the binary-opacity surgery applies at `step`."""
    return step > warmup and (step - warmup) % skip > margin


def binary_opacity_surgery(logit_opacities: torch.Tensor, step: int | None, *,
                           threshold: float, warmup: int, skip: int,
                           margin: int = 200,
                           due: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's binary opacities as logit-space param surgery at the
    top of each step (semantics and phase anchoring as in the JAX store).
    `due`, a 0-d bool device tensor, replaces the host phase test for a
    step that a CUDA graph replays (`step` None then)."""
    if due is None and not surgery_due(step, warmup=warmup, skip=skip,
                                       margin=margin):
        return logit_opacities
    binary = torch.where(logit_opacities >= threshold,
                         torch.ones_like(logit_opacities),
                         torch.zeros_like(logit_opacities))
    return binary if due is None else torch.where(due, binary, logit_opacities)


def activated(state: GaussianState):
    """Rasterizer-ready values: dead slots get opacity 0, and frozen slots
    contribute with detached geometry (the JAX stop_gradient)."""
    op = torch.sigmoid(state.logit_opacities)
    op = torch.where(state.alive, op, torch.zeros_like(op))
    scales = torch.exp(state.log_scales)
    frz = state.frozen
    means = torch.where(frz[:, None], state.means.detach(), state.means)
    scales = torch.where(frz[:, None], scales.detach(), scales)
    op = torch.where(frz, op.detach(), op)
    colors = torch.cat([state.features_dc[:, None, :], state.features_rest],
                       dim=1)  # (C, K, 3)
    return means, state.quats, scales, op, colors
