"""The port's spans in a torch.profiler trace: where a step's card time,
launches, idle time and host syncs go, by layer.

    python3 fsbench/spans.py --workload <name> --seed <n>

runs a cell's set-up (harness.set_up), profiles the refine interval after
the warm boundary as the harness's profiled interval does, and prints the
per-span table on standard error and one JSON object as the last line of
standard output.

The spans are the host records `fs.<layer>` that
fusionsense_tpu_torch/utils/profiling.py `span` opens while a profiler
runs, on the thread that entered Trainer.run (the thread of `fs.step`).
Each device interval (kernel, copy, fill) belongs to the innermost span
that thread had open when the interval's launch call ran, found through
the launch's correlation id: autograd launches the backward's kernels from
its own thread, inside the main thread's `fs.backward`. Busy time is the
union of the device intervals (trace.union), each stretch counted once, for
the interval that covers it first; idle time, the holes in that union, goes
to the span the main thread had open during the hole; launch and sync calls
(any thread) to the span open at their start. Annotation events (a
user-scope record_function's span on the card's timeline) are left out of
the device intervals. A profile without fs.step puts everything under
OUTSIDE.
"""
from __future__ import annotations

import bisect
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fsbench.trace import LAUNCH_CALLS, union  # noqa: E402

PREFIX = "fs."
OUTSIDE = "(outside)"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def records(prof) -> dict:
    """The profile as lists, times in ns: device (start, end, correlation
    id) of every kernel, copy and fill; launches (host start, correlation
    id) of LAUNCH_CALLS; syncs (host start) of SYNC_CALLS; spans (name,
    start, end, thread) of every fs.* record."""
    from torch.autograd import DeviceType

    dev, launches, syncs, spans = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, s + e.duration_ns(), e.correlation_id()))
            continue
        name = e.name()
        if name in LAUNCH_CALLS:
            launches.append((s, e.correlation_id()))
        elif name in SYNC_CALLS:
            syncs.append(s)
        elif name.startswith(PREFIX):
            spans.append((name, s, s + e.duration_ns(), e.start_thread_id()))
    return dict(device=dev, launches=launches, syncs=syncs, spans=spans)


def timeline(spans) -> tuple:
    """Nested (name, start, end) -> (edges, labels): the innermost span
    open on [edges[i], edges[i + 1]) is labels[i], OUTSIDE where none is
    (and after the last edge)."""
    edges, labels, stack = [], [], []

    def mark(t):
        label = stack[-1][0] if stack else OUTSIDE
        if edges and edges[-1] == t:
            labels[-1] = label
        else:
            edges.append(t)
            labels.append(label)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            mark(stack.pop()[2])
        stack.append((name, s, e))
        mark(s)
    while stack:
        mark(stack.pop()[2])
    return edges, labels


def label_at(edges, labels, t) -> str:
    i = bisect.bisect_right(edges, t) - 1
    return OUTSIDE if i < 0 else labels[i]


def split(edges, labels, a, b) -> list:
    """[(label, ns)] of the stretch [a, b) over the timeline."""
    out = []
    i = bisect.bisect_right(edges, a) - 1
    t = a
    while t < b:
        end = min(b, edges[i + 1]) if i + 1 < len(edges) else b
        out.append((OUTSIDE if i < 0 else labels[i], end - t))
        t, i = end, i + 1
    return out


def main_thread(spans):
    """The thread of the first fs.step (the one that entered Trainer.run);
    None without one."""
    return next((t for n, _, _, t in spans if n == PREFIX + "step"), None)


def reduce(rec: dict) -> dict:
    """records() -> steps (the count of fs.step), busy_s, idle_s, per span
    name (OUTSIDE included) its count and, per step, device_ms, launches,
    idle_ms and syncs, and in_spans_share / outside_share: the shares of
    the busy time inside some span and outside every span (%)."""
    main = main_thread(rec["spans"])
    mine = [(n, s, e) for n, s, e, t in rec["spans"] if t == main]
    edges, labels = timeline(mine)
    rows: dict = {}

    def row(name):
        return rows.setdefault(name, dict(count=0, device_ms=0.0, launches=0,
                                          idle_ms=0.0, syncs=0))

    for n, _, _ in mine:
        row(n)["count"] += 1
    launched = {}       # correlation id -> the span of its launch call
    for s, c in rec["launches"]:
        launched[c] = label_at(edges, labels, s)
        row(launched[c])["launches"] += 1
    for s in rec["syncs"]:
        row(label_at(edges, labels, s))["syncs"] += 1
    covered = 0         # each stretch of the busy union counted once
    for s, e, c in sorted(rec["device"]):
        if e > max(s, covered):
            row(launched.get(c, OUTSIDE))["device_ms"] += (
                e - max(s, covered)) / 1e6
            covered = e
    merged = union([(s, e) for s, e, _ in rec["device"]])
    for (_, a), (b, _) in zip(merged, merged[1:]):
        for label, ns in split(edges, labels, a, b):
            row(label)["idle_ms"] += ns / 1e6
    busy = sum(e - s for s, e in merged)
    idle = sum(b - a for (_, a), (b, _) in zip(merged, merged[1:]))
    outside = 1e6 * rows.get(OUTSIDE, {}).get("device_ms", 0.0)
    steps = sum(n == PREFIX + "step" for n, _, _ in mine)
    for r in rows.values():
        for k in ("device_ms", "launches", "idle_ms", "syncs"):
            r[k] /= max(steps, 1)
    share = (lambda ns: 100.0 * ns / busy) if busy else (lambda ns: None)
    return dict(steps=steps, busy_s=busy / 1e9, idle_s=idle / 1e9,
                spans=rows, in_spans_share=share(busy - outside),
                outside_share=share(outside))


def table(red: dict) -> str:
    """The per-span rows of reduce() as text, by device time."""
    lines = [f"{'span':20s} {'count':>6s} {'device ms':>10s} {'launches':>9s}"
             f" {'idle ms':>9s} {'syncs':>6s}   (per step of "
             f"{red['steps']})"]
    for name, r in sorted(red["spans"].items(),
                          key=lambda kv: -kv[1]["device_ms"]):
        lines.append(f"{name:20s} {r['count']:6d} {r['device_ms']:10.4f} "
                     f"{r['launches']:9.2f} {r['idle_ms']:9.4f} "
                     f"{r['syncs']:6.2f}")
    return "\n".join(lines)


def summary(red: dict, records: list, steps: int) -> dict:
    """What the spans and the pair counters give per step: fs.bin's and
    fs.update's device ms, the share of the idle time inside fs.backward
    (%), the sync calls inside any span, and the pairs dropped past the
    pair budget or K and cut by the cover window: the sums of Trainer.run's
    history `records` of `steps` steps that begin on a log boundary."""
    rows = red["spans"]
    get = lambda name, k: rows.get(PREFIX + name, {}).get(k, 0.0)  # noqa: E731
    idle = sum(r["idle_ms"] for r in rows.values())
    pairs = {k: sum(h[k] for h in records) / steps
             if records and k in records[0] else None
             for k in ("pairs_dropped", "pairs_truncated")}
    return dict(bin_device_ms=get("bin", "device_ms"),
                update_device_ms=get("update", "device_ms"),
                backward_idle_share=(100.0 * get("backward", "idle_ms") / idle
                                     if idle else None),
                host_syncs_per_step=sum(r["syncs"] for k, r in rows.items()
                                        if k != OUTSIDE),
                pairs_dropped_per_step=pairs["pairs_dropped"],
                pairs_truncated_per_step=pairs["pairs_truncated"])


def profile_spans(workload: str, seed: int, *, device=None, shrink=None
                  ) -> dict:
    """Set-up, then the refine interval after the warm boundary under
    torch.profiler (as harness.profiled_interval runs it) -> the busy time
    and launches as trace.py reduces them, the spans as reduce() does, and
    summary(). `device` and `shrink` are for tests on the CPU."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from fsbench import harness as H
    from fsbench import trace as TR

    su = H.set_up(workload, seed, device=device, shrink=shrink)
    tr, dev = su["tr"], su["dev"]
    every = tr.cfg.train.adc.refine_every
    s0, h0 = tr.step, len(tr.history)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    H._sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.run(iterations=s0 + every, log=None)
        H._sync(dev)
        wall = time.perf_counter() - t0
    steps = tr.step - s0
    t0 = time.perf_counter()
    ev = TR.events(prof)
    red = reduce(records(prof))
    return dict(
        workload=workload, seed=seed, steps=(s0, tr.step),
        card=H.card() if dev.type == "cuda" else "cpu",
        profiled_wall_s=wall, reduce_s=time.perf_counter() - t0,
        trace_busy_ms=1e3 * TR.busy_seconds(ev) / steps,
        trace_launches=ev["launches"] / steps, spans=red,
        **summary(red, tr.history[h0:], steps))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from fsbench.harness import RunError

    try:
        out = profile_spans(args.workload, args.seed)
    except RunError as e:
        print(f"fsbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    print(table(out["spans"]), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
