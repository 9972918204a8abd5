"""Adaptive density control: config and the per-step densification stats.

Counterpart of the first half of fusionsense_tpu/gaussians/adc.py.
`refine` (split / dup / cull / opacity reset) is not ported yet; the trainer
raises when a run reaches its first refine step (ROADMAP N1).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ADCConfig:
    warmup: int = 500
    refine_every: int = 100
    stop_split_at: int = 10_000
    reset_alpha_every: int = 30           # in units of refine_every
    densify_grad_thresh: float = 0.005
    densify_size_thresh: float = 0.01     # world units (scene-scaled)
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5        # world units
    cull_screen_size: float = 0.15        # fraction of screen
    split_screen_size: float = 0.05       # fraction of screen
    stop_screen_size_at: int = 4000
    n_split_samples: int = 2
    split_scale_shrink: float = 1.6


@dataclasses.dataclass
class RefineStats:
    """Accumulated between refinement steps."""

    grad2d_acc: torch.Tensor   # (C,) sum of screen-space grad norms
    count: torch.Tensor        # (C,) int32 visibility counts
    max_radius: torch.Tensor   # (C,) max screen radius seen (screen fraction)

    def fields(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def init_stats(capacity: int, device) -> RefineStats:
    z = torch.zeros((capacity,), dtype=torch.float32, device=device)
    return RefineStats(grad2d_acc=z,
                       count=torch.zeros((capacity,), dtype=torch.int32,
                                         device=device),
                       max_radius=z.clone())


def accumulate_stats(stats: RefineStats, mean2d_grad: torch.Tensor,
                     radius: torch.Tensor, width: int,
                     height: int) -> RefineStats:
    """Fold one step's screen-space gradients into the running stats
    (pixel-space grad norms scaled by 0.5*max(H, W), as in the JAX port)."""
    vis = radius > 0
    ext = max(width, height)
    norm = torch.linalg.norm(mean2d_grad, dim=-1) * (0.5 * ext)
    zero = torch.zeros_like(norm)
    return RefineStats(
        grad2d_acc=stats.grad2d_acc + torch.where(vis, norm, zero),
        count=stats.count + vis.to(torch.int32),
        max_radius=torch.maximum(stats.max_radius,
                                 torch.where(vis, radius, zero) / ext),
    )
