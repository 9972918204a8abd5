"""Adaptive density control (densify / split / dup / cull / opacity reset)
as masked tensor ops over the fixed-capacity store.

Counterpart of fusionsense_tpu/gaussians/adc.py:
- every `refine_every` steps after `warmup` until `stop_split_at`:
  Gaussians whose average screen gradient exceeds densify_grad_thresh are
  SPLIT (large: n_split_samples children, scales / 1.6) or DUPLICATED
  (small); low-opacity and (after the first reset) oversized ones are
  culled,
- every `reset_alpha_every * refine_every` steps: opacities clamped to
  2 * cull_alpha_thresh and their Adam moments zeroed,
- frozen (touch-anchored) Gaussians are left out of all of it.
No tensor changes shape and nothing is read back to the host: culls clear
`alive`, allocations rank the free slots with a stable argsort and a cumsum
and write only the granted rows. The random draw (`split_noise`) is apart
from the arithmetic (`refine(..., noise=...)`), so a caller can feed the
normals another generator drew.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from fusionsense_tpu_torch.core.transforms import quat_to_rotmat
from fusionsense_tpu_torch.gaussians.store import GaussianState
from fusionsense_tpu_torch.train.optim import AdamState


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


def _alloc_free_slots(alive: torch.Tensor, request: torch.Tensor):
    """Rank free slots; request[i] = True wants one new slot for source i.

    Returns (dest (C,), granted (C,) bool): the destination slot of each
    granted request. Requests beyond the free-slot count are not granted."""
    free = ~alive
    num_free = torch.sum(free)
    # free slots first, in slot order: a stable argsort of an integer mask
    free_idx = torch.argsort((~free).to(torch.int8), stable=True)
    rank = torch.cumsum(request, 0) - 1                  # rank among requests
    granted = request & (rank < num_free)
    dest = free_idx[torch.clamp(rank, 0, alive.shape[0] - 1)]
    return dest, granted


def _write_slots(arr: torch.Tensor, dest: torch.Tensor, granted: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """arr with values[i] written to arr[dest[i]] wherever granted[i]. Rows
    not granted go to a scratch row past the end, which is dropped (the
    JAX scatter's mode="drop")."""
    c = arr.shape[0]
    out = torch.cat([arr, arr[:1]], 0)
    safe = torch.where(granted, dest, torch.full_like(dest, c))
    out.index_put_((safe,), values.to(arr.dtype))
    return out[:c]


def split_noise(generator: torch.Generator, n: int, capacity: int,
                device=None) -> torch.Tensor:
    """(max(n, 2), capacity, 3) standard normals for refine's split
    children, drawn from `generator` (which must live on `device`)."""
    return torch.randn((max(n, 2), capacity, 3), generator=generator,
                       device=device)


def refine(state: GaussianState, opt: AdamState, stats: RefineStats,
           noise: torch.Tensor, cfg: ADCConfig, step: int,
           scene_scale: float = 1.0):
    """One refinement pass at host step `step`; `noise` is split_noise's
    draw for this capacity. Returns (state, opt, fresh stats, info), info's
    counts as device tensors (culled, split, dupped, alloc_dropped,
    opacity_reset)."""
    C = state.capacity
    dev = state.device
    active = state.alive & ~state.frozen
    can_split = step < cfg.stop_split_at

    avg_grad = stats.grad2d_acc / torch.clamp_min(stats.count, 1)
    seen = stats.count > 0
    high = active & seen & (avg_grad > cfg.densify_grad_thresh)
    if not can_split:
        high = torch.zeros_like(high)

    max_scale = torch.amax(torch.exp(state.log_scales), dim=-1)
    big_world = max_scale > cfg.densify_size_thresh * scene_scale
    consider_screen = step < cfg.stop_screen_size_at
    big = big_world
    if consider_screen:
        big = big | (stats.max_radius > cfg.split_screen_size)
    split_mask = high & big
    dup_mask = high & ~split_mask

    # culling
    opacity = torch.sigmoid(state.logit_opacities)
    cull = active & (opacity < cfg.cull_alpha_thresh)
    if step > cfg.warmup + cfg.reset_alpha_every * cfg.refine_every:
        too_big = max_scale > cfg.cull_scale_thresh * scene_scale
        if consider_screen:
            too_big = too_big | (stats.max_radius > cfg.cull_screen_size)
        cull = cull | (active & too_big)
    alive = state.alive & ~cull

    # allocation: one new slot per dup, n_split - 1 per split (child 0
    # overwrites the original slot)
    orig = state.params()
    params = dict(orig)
    shrink = math.log(cfg.split_scale_shrink)
    R = quat_to_rotmat(orig["quats"])

    def split_child(i):
        """Split child i of every Gaussian, from the original params."""
        local = noise[i] * torch.exp(orig["log_scales"])
        child = dict(orig)
        child["means"] = orig["means"] + torch.einsum("nij,nj->ni", R, local)
        child["log_scales"] = orig["log_scales"] - shrink
        return child

    total_granted = torch.zeros((), dtype=torch.int64, device=dev)
    total_requested = (torch.sum(dup_mask)
                       + torch.sum(split_mask) * (cfg.n_split_samples - 1))
    m, v, acc = dict(opt.m), dict(opt.v), dict(opt.acc)
    split_granted = split_mask
    passes = [(dup_mask, None)] + [(split_mask, i)
                                   for i in range(1, cfg.n_split_samples)]
    for req, child in passes:
        dest, granted = _alloc_free_slots(alive, req)
        if child is None:
            src = orig                      # a dup copies the original
        else:
            src = split_child(child)
            split_granted = split_granted & granted
        for k in params:
            params[k] = _write_slots(params[k], dest, granted, src[k])
        # new slots start with zero moments
        for tree in (m, v, acc):
            for k in tree:
                tree[k] = _write_slots(tree[k], dest, granted,
                                       torch.zeros((), device=dev))
        alive = _write_slots(alive, dest, granted,
                             torch.ones((), dtype=torch.bool, device=dev))
        total_granted = total_granted + torch.sum(granted)

    # child 0 replaces the original only where the other children were
    # allocated: a full store must not shrink its originals at every refine
    child0 = split_child(0)
    for k in params:
        sel = split_granted.reshape((-1,) + (1,) * (params[k].ndim - 1))
        params[k] = torch.where(sel, child0[k], params[k])

    new_state = state.replace(alive=alive, **params)
    new_opt = AdamState(m=m, v=v, acc=acc, counts=opt.counts)

    # opacity reset
    refine_idx = (step - cfg.warmup) // cfg.refine_every
    do_reset = (refine_idx > 0 and refine_idx % cfg.reset_alpha_every == 0
                and can_split)
    if do_reset:
        reset_logit = math.log(2 * cfg.cull_alpha_thresh
                               / (1 - 2 * cfg.cull_alpha_thresh))
        lo = new_state.logit_opacities
        new_state = new_state.replace(logit_opacities=torch.where(
            new_state.alive & ~new_state.frozen,
            torch.clamp_max(lo, reset_logit), lo))
        new_opt.m["logit_opacities"] = torch.zeros_like(m["logit_opacities"])
        new_opt.v["logit_opacities"] = torch.zeros_like(v["logit_opacities"])

    info = {"culled": torch.sum(cull), "split": torch.sum(split_mask),
            "dupped": torch.sum(dup_mask),
            "alloc_dropped": total_requested - total_granted,
            "opacity_reset": torch.full((), do_reset, dtype=torch.bool,
                                        device=dev)}
    return new_state, new_opt, init_stats(C, dev), info
