"""Tracing on torch.profiler's clock: spans inside the port and the reads of
a finished profile.

Counterpart of fusionsense_tpu/utils/profiling.py:
- `span(name, step)` marks a layer of the training step (`fs.<layer>`)
  while a torch.profiler runs, and costs a flag check otherwise,
- `trace(dir)` wraps torch.profiler (the card's kernels too when CUDA is
  available); `device_time` and `host_calls` read the finished profile.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

# CUDA API calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")

_NO_SPAN = contextlib.nullcontext()


def span(name: str, step: int | None = None):
    """A host span `name` (with the step number, when given, as its
    argument) while a torch.profiler runs; else one shared null context.

    The span is a function-scope record function, not record_function's
    user scope: kineto gives every user-scope record an annotation event
    on the card's timeline, from its first kernel to its last, and a
    reduction that takes every CUDA-typed event as device work would count
    the annotation's idle holes as busy. A function-scope record puts
    nothing on the card's timeline."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if step is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, [], {"step": step})


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
    their summed self time, their count, and the rows by time. Annotation
    rows (a user-scope record's span on the card's timeline) are no
    kernels and are left out."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.is_user_annotation]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows), rows)


def host_calls(prof) -> int:
    """How many times the host put work on the card (LAUNCH_CALLS)."""
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
