"""CUDA graphs of the training step, replayed by Trainer.run_fused.

The JAX trainer runs a refine interval as one lax.scan dispatch
(fusionsense_tpu/train/trainer.py make_fused_intervals). The port's eager
step launches some 2,000-2,400 kernels from the host, so its time is the
host's (PERF.md section 5). Here each step of an interval is one replay of
a CUDA graph captured from the eager step: one host call per step.

What makes a replay correct at any step and in any order:

- Persistent buffers. A captured step reads and writes only tensors that
  exist before its capture: the training state, the per-view bins, the
  interval's step table and its counter, and the metrics
  (trainer.FusedIntervals owns them). Its results reach them by copy_.
- Step-dependent host values are device inputs (trainer.StepInputs: the
  learning rates, the accumulation gates, the SH band, the binary-opacity
  surgery flag, and the view, all read at the step counter) or the key
  (the flat bin cache's rebin decision: two graphs, or one without it). The SDF draw's generator is
  registered with every graph and seeded with the step on the host before
  each replay, which is what the eager step's fresh generator draws; a
  capture restores the generator's state after its warm-up and recording,
  so the replay that follows a capture draws from the caller's seed too.
- One memory pool for all graphs. The captured function returns nothing and
  keeps no reference, so once a capture ends no tensor of the pool is
  alive: `_capture` checks that the pool holds no allocated byte then. A
  replay may therefore overwrite any block of the pool: no block holds
  anything that another graph, or a later replay, reads. That is why
  sharing the pool is safe in any replay order, not only in capture order.

Each graph is captured after one eager warm-up of the same step, with its
results discarded, on the capture stream (lazy library set-up, the
kernels' shared-memory attribute, allocator warm-up). A failed capture
raises, naming the step's key and the cause; nothing falls back to the
eager step. Launch counts: a kernel launched under capture is recorded,
not run, so the kernel modules count it in CAPTURED; each replay adds the
graph's recorded launches to REPLAYED here.
"""
from __future__ import annotations

import time

import torch

from fusionsense_tpu_torch.render import composite2, flat_composite

_KERNELS = (flat_composite, composite2)

# kernel launches made by graph replays, per kernel entry point (the keys
# of the kernel modules' CAPTURED); chip_smoke.py zeroes these with the
# modules' own counts before driving a path and adds them after
REPLAYED = {k: 0 for mod in _KERNELS for k in mod.CAPTURED}


def reset_launch_counts() -> None:
    for k in REPLAYED:
        REPLAYED[k] = 0


def _captured() -> dict:
    return {k: v for mod in _KERNELS for k, v in mod.CAPTURED.items()}


def pool_bytes(pool) -> tuple[int, int]:
    """(allocated, reserved) bytes of the segments of a graph memory pool."""
    allocated = reserved = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", ())) == tuple(pool):
            allocated += seg["allocated_size"]
            reserved += seg["total_size"]
    return allocated, reserved


class StepGraphs:
    """One CUDA graph per key of a step function `body(commit)` that reads
    and writes only persistent buffers (commit=False: compute, write
    nothing). All graphs share `pool`; `generator`, when given, is
    registered with each."""

    def __init__(self, pool, generator: torch.Generator | None = None):
        self.pool = pool
        self.generator = generator
        self.stream = torch.cuda.Stream()
        self.graphs: dict = {}     # key -> (CUDAGraph, launches it records)
        self.capture_s = 0.0
        self.replays = 0

    def run(self, key, body) -> None:
        """Replay the graph of `key`, capturing `body` first if it has none."""
        if key not in self.graphs:
            self.graphs[key] = self._capture(key, body)
        graph, launches = self.graphs[key]
        graph.replay()
        self.replays += 1
        for k, n in launches.items():
            REPLAYED[k] += n

    def _capture(self, key, body):
        t0 = time.perf_counter()
        # the warm-up draws and the capture advances the generator: both
        # must leave it as the caller seeded it for the first replay
        rng = None if self.generator is None else self.generator.get_state()
        s = self.stream
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            body(commit=False)
        torch.cuda.current_stream().wait_stream(s)
        before = _captured()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=s):
                body(commit=True)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the training step {key} as a CUDA graph failed "
                f"(a host sync, a host-to-device copy or an unregistered "
                f"generator in the step): {e}") from e
        after = _captured()
        if rng is not None:
            self.generator.set_state(rng)
        live, _ = pool_bytes(self.pool)
        if live:
            raise RuntimeError(
                f"the captured step {key} left {live} bytes of the shared "
                "graph pool allocated; another graph's replay would "
                "overwrite them")
        self.capture_s += time.perf_counter() - t0
        return graph, {k: after[k] - before[k] for k in after}
