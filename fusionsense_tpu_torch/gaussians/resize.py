"""Capacity bucketing and alive-first compaction of the training state.

Counterpart of fusionsense_tpu/gaussians/resize.py.
"""
from __future__ import annotations

import torch

from fusionsense_tpu_torch.gaussians.adc import RefineStats
from fusionsense_tpu_torch.gaussians.store import GaussianState
from fusionsense_tpu_torch.train.optim import AdamState


def next_bucket(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pick_capacity(n_alive: int, current: int, maximum: int,
                  minimum: int = 1024) -> int:
    """Target bucket given the live count; hysteresis avoids thrash."""
    want = min(next_bucket(int(n_alive * 2), minimum), maximum)
    if n_alive > 0.8 * current:
        return max(want, min(current * 2, maximum))
    if n_alive < 0.3 * current and want < current:
        return want
    return current


def _map_state(gaussians, opt, stats, fn):
    g = GaussianState(**{k: fn(v) for k, v in gaussians.fields().items()})
    opt2 = AdamState(m={k: fn(v) for k, v in opt.m.items()},
                     v={k: fn(v) for k, v in opt.v.items()},
                     acc={k: fn(v) for k, v in opt.acc.items()},
                     counts=opt.counts)
    st = RefineStats(**{k: fn(v) for k, v in stats.fields().items()})
    return g, opt2, st


def _alive_first(alive: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting alive slots first."""
    return torch.argsort((~alive).to(torch.int8), stable=True)


def resize_train_state(gaussians: GaussianState, opt: AdamState,
                       stats: RefineStats, new_capacity: int):
    """Grow by padding with dead slots; shrink by an alive-first stable
    permutation and a slice (the caller guarantees new_capacity >= alive)."""
    old = gaussians.capacity
    if new_capacity == old:
        return gaussians, opt, stats
    if new_capacity > old:
        pad = new_capacity - old
        return _map_state(gaussians, opt, stats, lambda x: torch.cat(
            [x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                            device=x.device)], 0))
    perm = _alive_first(gaussians.alive)[:new_capacity]
    return _map_state(gaussians, opt, stats, lambda x: x[perm])


def compact_train_state(gaussians: GaussianState, opt: AdamState,
                        stats: RefineStats):
    """Stable alive-first permutation at constant capacity: every alive slot
    lands in [0, num_alive), so rasterization can run on a prefix."""
    perm = _alive_first(gaussians.alive)
    return _map_state(gaussians, opt, stats, lambda x: x[perm])


def render_bucket(n_alive: int, capacity: int, minimum: int = 1024,
                  margin: float = 1.2) -> int:
    """Render-prefix length covering n_alive with growth headroom, on a
    pow2-and-1.5*pow2 ladder."""
    want = max(int(n_alive * margin), minimum)
    b = minimum
    while b < want:
        b = b + b // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return min(b, capacity)
