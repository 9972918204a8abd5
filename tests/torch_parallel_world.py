"""A world of gloo ranks on the CPU for the port's multi-device tests.

World(size, tmp) spawns `size` processes once; each starts its rank with
parallel.mesh.init_ranks (a file:// rendezvous under `tmp`, so that
concurrent test workers never meet on a TCP port) and then serves jobs:
world.run(fn, **kw) calls fn(**kw) on every rank and returns the ranks'
results in rank order. fn must be importable by name (a module-level
function) and its results picklable. A job that raises on any rank, or a
rank that dies, fails the call, and the world is torn down then (the
other ranks may be stuck in a collective). Nothing here imports JAX.
"""
from __future__ import annotations

import os
import queue
import time
import traceback

import torch.multiprocessing as mp

JOB_TIMEOUT = 600     # seconds a job may take on every rank


def _serve(rank: int, size: int, url: str, jobs, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    import torch
    import torch.distributed as dist

    from fusionsense_tpu_torch.parallel.mesh import init_ranks

    torch.set_num_threads(1)
    init_ranks(device="cpu", init_method=url)
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, kw = job
        try:
            results.put((rank, True, fn(**kw)))
        except BaseException:   # noqa: BLE001 - reported to the caller
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, size: int, tmp):
        ctx = mp.get_context("spawn")
        self.size = size
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(size)]
        url = f"file://{os.fspath(tmp)}/rendezvous"
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, size, url, self.jobs[r],
                                        self.results))
                      for r in range(size)]
        for p in self.procs:
            p.start()

    def run(self, fn, **kw) -> list:
        for q in self.jobs:
            q.put((fn, kw))
        out = [None] * self.size
        deadline = time.monotonic() + JOB_TIMEOUT
        for _ in range(self.size):
            while True:
                try:
                    rank, ok, res = self.results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if not p.is_alive()]
                    if dead or time.monotonic() > deadline:
                        self.close(kill=True)
                        raise RuntimeError(
                            f"{fn.__name__}: ranks {dead} died" if dead else
                            f"{fn.__name__}: no answer from every rank in "
                            f"{JOB_TIMEOUT} s")
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n"
                                   f"{res}")
            out[rank] = res
        return out

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q in self.jobs:
                q.put(None)
        for p in self.procs:
            if kill:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
