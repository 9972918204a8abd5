"""Batch experiment runner: sweep presets x scenes, collect a results table.

Counterpart of fusionsense_tpu/eval/batch.py (the reference's
eval/batch_run.py:16,74): run a list of (scene, preset) combinations
through the port's ReconstructionPipeline and gather their train-split
metrics into one summary.json. A job that fails is recorded with its error
and the sweep goes on.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path


@dataclasses.dataclass
class BatchJob:
    data_dir: str
    preset: str = "dn-splatter"
    dataset: str = "nerfstudio"
    iterations: int | None = None
    load_touches: bool = False
    name: str | None = None


def run_batch(jobs: list[BatchJob], output_dir="batch_outputs", log=print,
              device=None):
    """Train and evaluate each job in turn on `device` (the card by
    default); returns the per-job results, also written to
    output_dir/summary.json."""
    from fusionsense_tpu_torch.data.dataparser import DataParserConfig
    from fusionsense_tpu_torch.device import resolve_device
    from fusionsense_tpu_torch.pipeline import (
        PipelineConfig, ReconstructionPipeline,
    )
    from fusionsense_tpu_torch.presets import PRESETS

    dev = resolve_device(device)
    output_dir = Path(output_dir)
    results = []
    for job in jobs:
        name = job.name or f"{Path(job.data_dir).name}_{job.preset}"
        exp = PRESETS[job.preset]()
        if job.iterations:
            exp = dataclasses.replace(
                exp, train=dataclasses.replace(exp.train,
                                               iterations=job.iterations))
        cfg = PipelineConfig(
            data=DataParserConfig(data_dir=job.data_dir,
                                  load_touches=job.load_touches),
            experiment=exp,
            output_dir=str(output_dir / name),
        )
        t0 = time.time()
        try:
            pipe = ReconstructionPipeline(cfg, device=dev)
            pipe.train(log=None)
            res = pipe.evaluate("train")["mean"]
            res["wall_s"] = time.time() - t0
            res["status"] = "ok"
        except Exception as e:  # keep sweeping on failures
            res = {"status": f"error: {e}", "wall_s": time.time() - t0}
        res["job"] = name
        results.append(res)
        if log:
            log(f"[{name}] {res}")

    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "summary.json", "w") as f:
        json.dump(results, f, indent=2, default=str)
    return results
