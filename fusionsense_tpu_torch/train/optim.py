"""Per-group masked Adam with fixed-capacity moments.

Counterpart of fusionsense_tpu/train/optim.py. torch.optim.Adam is not used:
this optimizer masks updates to alive slots, accumulates gradients for
every_k groups, and keeps a per-group update counter for bias correction,
exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    lr_init: float
    lr_final: float | None = None      # None -> constant LR
    max_steps: int = 15_000
    every_k: int = 1                   # gradient accumulation interval
    eps: float = 1e-15


DEFAULT_GROUPS: dict[str, GroupSpec] = {
    "means": GroupSpec(1.6e-4, 1.6e-6, 15_000),
    "features_dc": GroupSpec(2.5e-3, every_k=10),
    "features_rest": GroupSpec(2.5e-3 / 20, every_k=10),
    "logit_opacities": GroupSpec(5e-2),
    "log_scales": GroupSpec(5e-3),
    "quats": GroupSpec(1e-3),
    "normals": GroupSpec(0.0),
}


def group_lr(spec: GroupSpec, step: int) -> float:
    """Learning rate at a host-side step, computed in float32 as the JAX
    schedule is."""
    if spec.lr_final is None or spec.lr_final == spec.lr_init:
        return float(np.float32(spec.lr_init))
    t = np.clip(np.float32(step) / np.float32(spec.max_steps),
                np.float32(0), np.float32(1))
    ratio = np.float32(spec.lr_final / spec.lr_init)
    return float(np.float32(spec.lr_init) * np.power(ratio, t))


@dataclasses.dataclass
class AdamState:
    m: dict       # first moments, keyed like the params
    v: dict       # second moments
    acc: dict     # accumulated grads for every_k groups
    counts: dict  # per-group 0-d int32 update counters (bias correction)


def init_adam(params: dict) -> AdamState:
    return AdamState(
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
        acc={k: torch.zeros_like(p) for k, p in params.items()},
        counts={k: torch.zeros((), dtype=torch.int32, device=p.device)
                for k, p in params.items()},
    )


def adam_step(params: dict, grads: dict, state: AdamState, step: int | None,
              alive: torch.Tensor, groups: dict | None = None,
              b1: float = 0.9, b2: float = 0.999, lr: dict | None = None,
              gate: dict | None = None):
    """One (possibly accumulating) Adam step over all groups; returns
    (new_params, new_state). `step` is the host-side step number. Updates
    are masked to alive slots; dead slots keep params and moments.

    `lr` and `gate` (0-d device tensors keyed like the params) stand in for
    what the host step gives, for a step that a CUDA graph replays and so
    cannot read `step` (pass None then): lr[k] is the group's rate (float32,
    as group_lr computes it), gate[k] whether an every_k > 1 group applies
    its accumulated update. The gated values are selected on the device,
    and equal the host branch's bit for bit."""
    groups = groups or DEFAULT_GROUPS
    new_p, new_m, new_v, new_acc, new_counts = {}, {}, {}, {}, {}
    for k, p in params.items():
        spec = groups[k]
        acc = state.acc[k] + grads[k]
        on = None if gate is None or spec.every_k <= 1 else gate[k]
        if gate is None and not (spec.every_k <= 1
                                 or (step + 1) % spec.every_k == 0):
            new_p[k], new_m[k], new_v[k] = p, state.m[k], state.v[k]
            new_acc[k], new_counts[k] = acc, state.counts[k]
            continue
        g = acc
        cnt = state.counts[k] + 1
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * g * g
        t = torch.clamp_min(cnt, 1).to(torch.float32)
        # fills, not torch.tensor: no host-to-device copy in the step
        mhat = m / (1 - torch.pow(torch.full((), b1, device=t.device), t))
        vhat = v / (1 - torch.pow(torch.full((), b2, device=t.device), t))
        rate = group_lr(spec, step) if lr is None else lr[k]
        upd = rate * mhat / (torch.sqrt(vhat) + spec.eps)
        mask = alive.reshape(alive.shape + (1,) * (p.ndim - 1))
        new_p[k] = torch.where(mask, p - upd, p)
        new_m[k] = torch.where(mask, m, state.m[k])
        new_v[k] = torch.where(mask, v, state.v[k])
        new_acc[k] = torch.zeros_like(acc)
        new_counts[k] = cnt
        if on is not None:
            new_p[k] = torch.where(on, new_p[k], p)
            new_m[k] = torch.where(on, new_m[k], state.m[k])
            new_v[k] = torch.where(on, new_v[k], state.v[k])
            new_acc[k] = torch.where(on, new_acc[k], acc)
            new_counts[k] = torch.where(on, cnt, state.counts[k])
    return new_p, AdamState(m=new_m, v=new_v, acc=new_acc, counts=new_counts)
