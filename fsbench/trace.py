"""Reduction of a torch.profiler trace of a stretch of training steps.

From the profiler's raw event list (no file is written): every device
interval (kernels, copies and fills), the host's CUDA launch calls, and the
host's operators. The device's busy time is the union of its intervals
(overlapping streams counted once); the idle gaps are the holes in that
union, each named by the host operator that overlaps it most (the shortest
such operator on a tie).
"""
from __future__ import annotations

import numpy as np

# CUDA API calls that put work on the card: kernel and graph launches,
# copies and fills
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def events(prof) -> dict:
    """The profile as lists: device (name, start, end) of every kernel, copy
    and fill on the card, launches (a count), host (name, start, end) of
    every host operator and CUDA call; times in ns."""
    from torch.autograd import DeviceType

    dev, host = [], []
    launches = 0
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        row = (e.name(), s, s + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            dev.append(row)
        else:
            launches += row[0] in LAUNCH_CALLS
            host.append(row)
    return dict(device=dev, launches=launches, host=host)


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list: 'void (anonymous namespace)::k(float*)' -> 'k'."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


def union(intervals) -> list:
    """Merged [start, end] intervals of a list of (start, end)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(ev: dict) -> float:
    return sum(e - s for s, e in union([(s, e) for _, s, e in ev["device"]])) / 1e9


def by_kernel(ev: dict) -> dict:
    """{kernel name: device seconds}."""
    out: dict = {}
    for name, s, e in ev["device"]:
        k = kernel_name(name)
        out[k] = out.get(k, 0.0) + (e - s) / 1e9
    return out


def idle_gaps(ev: dict, top: int = 10) -> list:
    """The `top` longest holes in the device's busy union, as [host op,
    seconds]."""
    merged = union([(s, e) for _, s, e in ev["device"]])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    if not ev["host"]:
        return [["host", g / 1e9] for g, _, _ in gaps]
    names = [h[0] for h in ev["host"]]
    hs = np.array([h[1] for h in ev["host"]], dtype=np.int64)
    he = np.array([h[2] for h in ev["host"]], dtype=np.int64)
    out = []
    for g, s, e in gaps:
        ov = np.minimum(he, e) - np.maximum(hs, s)
        if ov.max() <= 0:
            out.append(["host (no operator)", g / 1e9])
            continue
        best = np.flatnonzero(ov == ov.max())
        i = best[np.argmin((he - hs)[best])]
        out.append([names[i], g / 1e9])
    return out


def top_kernels(ev: dict, top: int = 10) -> list:
    return [[k, s] for k, s in sorted(by_kernel(ev).items(),
                                      key=lambda kv: -kv[1])[:top]]
