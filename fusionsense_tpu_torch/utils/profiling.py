"""Lightweight tracing/profiling: per-phase wall timers + torch.profiler traces.

Counterpart of fusionsense_tpu/utils/profiling.py:
- `timer(name)` context / `@timed` decorator feeding a global registry
  (they synchronise the card before reading the clock, where JAX blocks on
  the result, so device work is actually measured),
- `trace(dir)` wraps torch.profiler (the card's kernels too when CUDA is
  available); `device_time` and `host_calls` read the finished profile,
- `report()` returns/prints the accumulated table.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path

import torch

_REGISTRY: dict[str, list[float]] = defaultdict(list)

# CUDA API calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _block(out) -> None:
    """Wait for the card if any tensor in `out` (nested dicts, lists,
    tuples) lies on it."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _block(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _block(v)


@contextlib.contextmanager
def timer(name: str, sync: bool = False, arg=None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync and arg is not None:
            _block(arg)
        _REGISTRY[name].append(time.perf_counter() - t0)


def timed(name: str | None = None, sync_result: bool = True):
    """Decorator: time the call; optionally wait for the returned tensors."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync_result:
                _block(out)
            _REGISTRY[label].append(time.perf_counter() - t0)
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed work with torch.profiler and yield the profiler;
    on exit wait for the card and, given `log_dir`, write trace.json there
    (chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def device_time(prof) -> tuple[float, int, list]:
    """(ms, launches, rows) of the device kernels in a finished profile:
    their summed self time, their count, and the rows by time."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows), rows)


def host_calls(prof) -> int:
    """How many times the host put work on the card (LAUNCH_CALLS)."""
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)


def report(reset: bool = False) -> dict:
    out = {}
    for name, samples in _REGISTRY.items():
        out[name] = {
            "calls": len(samples),
            "total_s": sum(samples),
            "mean_ms": 1e3 * sum(samples) / max(len(samples), 1),
            "last_ms": 1e3 * samples[-1],
        }
    if reset:
        _REGISTRY.clear()
    return out


def print_report(log=print, reset: bool = False):
    rep = report(reset=reset)
    for name in sorted(rep, key=lambda n: -rep[n]["total_s"]):
        r = rep[name]
        log(f"{name:40s} {r['calls']:6d} calls  "
            f"{r['mean_ms']:9.2f} ms/call  {r['total_s']:8.2f} s total")
    return rep
