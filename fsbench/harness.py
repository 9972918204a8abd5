"""One run of one cell: set-up, the timed window, the metrics, `correct`.

A cell of BENCHMARK.json joins a configuration (configs/<name>.json) and a
traffic mix (traffic/<name>.json); every metric is read by its own reader,
metrics/<name>.py, from the run's raw measurements. The limits of the
numbers compared for `correct` are in limits/<cell>.json.

Set-up (setup_s): build the CUDA kernels (cached in build/ of the checkout),
make the scene from the seed, build the Trainer with the callbacks the
pipeline passes for the scene (touch anchoring and intruder pruning when the
traffic has patches), then train with Trainer.run to the traffic's warm
boundary, keeping the state just before and after its refine.

Window: Trainer.run(iterations=step + refine_every) back to back, each call
ending synchronised, until --seconds are spent: fs-train's loop with its
refines, callbacks and log-boundary policies. Before it, at the end of
set-up, the refine interval after the warm boundary runs under
torch.profiler: the card's busy time per step (device_step_ms), its
launches and kernels. With --trace 1 the window's refine boundaries are
timed by CUDA events, and the profiled interval's compositing work is
counted by the reference once the window is over.

After the window: the peak memory is read, then the same Trainer runs on,
untimed, from the state the window ended on: three steps one call each
(their losses, the first gradient and the change after three kept with the
state they start from), then to the next refine boundary, whose state
before and after is kept. The program's state is freed, and the reference
checks what was kept (correct.py) and renders the state set-up ended on
(the warm boundary) for psnr_views.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from fsbench import correct as C
from fsbench import scene as S
from fsbench import trace as TR
from fsbench import work as WK
from fsbench.reference import render as RR
from fsbench.reference.step import sh_band

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fusionsense_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code != 0, no result line)."""


def log(msg: str) -> None:
    print(f"[fsbench] {msg}", file=sys.stderr, flush=True)


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def load_cell(workload: str, root: Path = HERE) -> tuple:
    """(cell entry, configuration, traffic, BENCHMARK.json) of a workload,
    each file found by its name; a workload BENCHMARK.json does not list is
    read as <configuration>.<traffic> on one chip."""
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    cell = cells.get(workload)
    if cell is None:
        # a cell not in BENCHMARK.json yet: <configuration>.<traffic>
        config, _, traffic = workload.partition(".")
        if not ((root / "configs" / f"{config}.json").exists()
                and (root / "traffic" / f"{traffic}.json").exists()):
            raise RunError(f"no workload {workload!r}")
        cell = {"name": workload, "config": config, "traffic": traffic,
                "chips": 1}
    config = json.loads((root / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic, bench


def run_config(config: dict, traffic: dict) -> dict:
    """The configuration as run: the file's groups with the traffic's
    overrides applied."""
    groups = ("model", "raster", "train", "adc", "loss", "optimizer", "touch")
    cfg = {g: config.get(g, {}) for g in groups}
    return merge(cfg, traffic.get("overrides", {}))


def experiment(cfg: dict, seed: int):
    """The program's ExperimentConfig and Adam groups of a run config."""
    from fusionsense_tpu_torch.config import (
        ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
    )
    from fusionsense_tpu_torch.gaussians.adc import ADCConfig
    from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
    from fusionsense_tpu_torch.train.optim import GroupSpec

    model = dict(cfg["model"], background=tuple(cfg["model"]["background"]))
    ec = ExperimentConfig(
        model=ModelConfig(rasterize=RasterizeConfig(**cfg["raster"]), **model),
        train=TrainConfig(adc=ADCConfig(**cfg["adc"]), seed=seed % (1 << 31),
                          **cfg["train"]),
        loss=LossConfig(**cfg["loss"]))
    groups = {k: GroupSpec(**g) for k, g in cfg["optimizer"].items()}
    return ec, groups


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _host(x):
    return x.detach().to("cpu", copy=True)


def snapshot(tr) -> dict:
    """The trainer's state as host copies: params, alive, frozen, the Adam
    moments and the refine stats."""
    g = tr.gaussians
    out = {k: _host(v) for k, v in g.params().items()}
    out["alive"], out["frozen"] = _host(g.alive), _host(g.frozen)
    for name in ("m", "v", "acc"):
        out[name] = {k: _host(v) for k, v in getattr(tr.opt, name).items()}
    out["stats"] = {k: _host(v) for k, v in tr.stats.fields().items()}
    return out


def touch_callback(patches: list, gel_scale: float, add_at: int):
    """The pipeline's touch callback for a scene with touch patches: anchor
    them all at the first boundary at or past add_at, then cull intruders
    at every later boundary."""
    from fusionsense_tpu_torch.data.tactile import TouchPatch
    from fusionsense_tpu_torch.gaussians.touch import (
        add_touch_patches, touch_prune,
    )

    tps = [TouchPatch(**p) for p in patches]
    state = {"added": False, "boxes": None}

    def touch_cb(tr):
        if not state["added"] and tr.step >= add_at:
            tr.gaussians, tr.opt, state["boxes"] = add_touch_patches(
                tr.gaussians, tr.opt, tps, gel_scale=gel_scale,
                scene_scale=1.0)
            state["added"] = True
            return True
        if state["added"]:
            tr.gaussians = touch_prune(tr.gaussians, state["boxes"])
            return True
        return False
    touch_cb.state = state
    return touch_cb


def build_trainer(cfg: dict, scn: dict, seed: int, dev):
    from fusionsense_tpu_torch.core.cameras import make_camera
    from fusionsense_tpu_torch.gaussians.store import new_state
    from fusionsense_tpu_torch.train.trainer import TrainData, Trainer

    ec, groups = experiment(cfg, seed)
    cams = scn["cams"]
    camera = make_camera(cams["viewmat"], cams["fx"], cams["fy"], cams["cx"],
                         cams["cy"], cams["width"], cams["height"], device=dev)
    data = TrainData(images=scn["images"], sensor_depths=scn["depths"],
                     mono_depths=scn["depths"], normals=scn["normals"])
    cap = cfg["model"]["capacity"]
    g = new_state(cap, cfg["model"]["sh_degree"], device=dev)
    n = scn["params0"]["means"].shape[0]
    for k, v in scn["params0"].items():
        getattr(g, k)[:n] = v
    g.alive[:n] = True
    callbacks = []
    if scn["patches"]:
        callbacks.append(touch_callback(scn["patches"],
                                        cfg["touch"]["gel_scale"],
                                        cfg["train"]["add_touch_at"]))
    tr = Trainer(ec, camera, data, g, scene_scale=1.0,
                 extra_callbacks=callbacks, adam_groups=groups, device=dev)
    return tr, callbacks


def start_rows(tr, params0: dict) -> float:
    """The start: slots of the constructed Trainer that differ from the
    seed cloud it was handed (rows 0..N-1 alive and equal, the rest dead),
    plus any nonzero Adam moment."""
    g, n = tr.gaussians, params0["means"].shape[0]
    bad = (~g.alive[:n]).sum() + g.alive[n:].sum()
    for k, v in params0.items():
        diff = getattr(g, k)[:n] != v
        bad = bad + diff.reshape(n, -1).any(-1).sum()
    for tree in (tr.opt.m, tr.opt.v, tr.opt.acc):
        bad = bad + sum((t != 0).sum() for t in tree.values())
    return float(bad)


def checked_steps(tr, n: int = 3) -> dict:
    """From a refine boundary (the state after it, as Trainer.run leaves
    it), n steps, one Trainer.run call each -> the state they start from
    (alive rows: params and frozen flags, Adam moments and counts), the
    program's losses, its first gradient as Adam holds it after one step,
    and its parameters after n steps."""
    g = tr.gaussians
    rows = torch.nonzero(g.alive)[:, 0]
    pick = lambda t: _host(t[rows])  # noqa: E731
    start = dict(step=tr.step, alive=_host(g.alive),
                 params=dict({k: pick(v) for k, v in g.params().items()},
                             frozen=pick(g.frozen)),
                 adam={name: {k: pick(v) for k, v in
                              getattr(tr.opt, name).items()}
                       for name in ("m", "v", "acc")})
    start["adam"]["counts"] = {k: int(v) for k, v in tr.opt.counts.items()}
    cover = [tr.cover_tiles]
    losses, after1 = [], None
    for k in range(1, n + 1):
        tr.run(iterations=start["step"] + k, log=None)
        losses.append(tr.history[-1]["loss"])
        cover.append(tr.cover_tiles)
        if k == 1:
            after1 = {name: {kk: pick(v) for kk, v in
                             getattr(tr.opt, name).items()}
                      for name in ("m", "acc")}
    same = bool(torch.equal(_host(tr.gaussians.alive), start["alive"]))
    params = ({k: pick(v) for k, v in tr.gaussians.params().items()}
              if same else None)
    return dict(start=start, losses=losses, after1=after1, params=params,
                cover=cover)


def warm_to_boundary(tr, warm: int, callbacks: list) -> dict:
    """Trainer.run to the warm boundary, keeping the state just before and
    just after its refine boundary, and what the touch step did there."""
    inner = tr.refine_boundary
    kept = {}

    def watched():
        if tr.step != warm:
            return inner()
        added0 = [cb.state["added"] for cb in callbacks]
        kept["step"] = tr.step
        kept["pre"] = snapshot(tr)
        info = inner()
        kept["post"] = snapshot(tr)
        added1 = [cb.state["added"] for cb in callbacks]
        kept["touch"] = (None if not callbacks else "prune" if added0[0]
                         else "anchor" if added1[0] else None)
        return info

    tr.refine_boundary = watched
    try:
        tr.run(iterations=warm, log=None)
    finally:
        del tr.refine_boundary
    if "pre" not in kept:
        raise RunError(f"no refine boundary at step {warm}")
    return kept


def time_boundaries(tr, dev) -> list:
    """Wrap tr.refine_boundary in CUDA events; the list fills with (start,
    end) pairs, read once the window is over."""
    inner = tr.refine_boundary
    marks = []

    def timed():
        if dev.type != "cuda":
            return inner()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        info = inner()
        b.record()
        marks.append((a, b))
        return info

    tr.refine_boundary = timed
    return marks


def window(tr, seconds: float, dev) -> dict:
    """Trainer.run one refine interval at a time until `seconds` are spent,
    each call ending on a synchronised boundary."""
    every = tr.cfg.train.adc.refine_every
    h0, s0 = len(tr.history), tr.step
    _sync(dev)
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        tr.run(iterations=tr.step + every, log=None)
        _sync(dev)
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    wall = marks[-1] - t0
    log("interval ms: " + " ".join(f"{1e3 * (b - a):.1f}"
                                   for a, b in zip(marks, marks[1:])))
    return dict(window_s=wall, window_steps=tr.step - s0,
                failed=sum(h["nonfinite_steps"] for h in tr.history[h0:]))


def alive_params(tr) -> dict:
    """The alive Gaussians' raw parameters (new tensors) and frozen flags."""
    g = tr.gaussians
    idx = torch.nonzero(g.alive)[:, 0]
    out = {k: v[idx].detach().clone() for k, v in g.params().items()}
    out["frozen"] = g.frozen[idx].clone()
    return out


def profiled_interval(tr, dev, keep: bool = False) -> dict:
    """One refine interval under torch.profiler, from the warm boundary:
    the card's busy time, launches and kernels of its steps. With `keep`,
    host copies of the alive Gaussians before and after it, to count the
    interval's compositing work from once the window is over."""
    from torch.profiler import ProfilerActivity, profile

    every = tr.cfg.train.adc.refine_every
    s0 = tr.step
    kept = {"steps": (s0, s0 + every)}
    if keep:
        kept["before"] = {k: _host(v) for k, v in alive_params(tr).items()}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.run(iterations=s0 + every, log=None)
        _sync(dev)
        wall = time.perf_counter() - t0
    if keep:
        kept["after"] = {k: _host(v) for k, v in alive_params(tr).items()}
    ev = TR.events(prof)
    return dict(profiled_steps=tr.step - s0, profiled_wall_s=wall,
                launches=ev["launches"], busy_s=TR.busy_seconds(ev),
                kernel_s=TR.by_kernel(ev), kept=kept,
                breakdown=dict(device_ops=TR.top_kernels(ev),
                               idle_gaps=TR.idle_gaps(ev)))


def interval_work(kept: dict, cfg: dict, scn: dict, dev) -> dict:
    """The compositing work per step of the profiled interval, counted by
    the reference from the state before and after it."""
    s0, s1 = kept["steps"]
    V = scn["images"].shape[0]
    counts = [RR.count_pairs({k: v.to(dev) for k, v in state.items()},
                             scn["cams"], cfg["raster"],
                             sh_band(cfg["model"], step), range(V))
              for state, step in ((kept["before"], s0), (kept["after"], s1))]
    pixels = scn["cams"]["width"] * scn["cams"]["height"]
    ops = nbytes = 0.0
    for s in range(s0, s1):
        v = s % V
        pairs = 0.5 * (counts[0][v][0] + counts[1][v][0])
        vis = 0.5 * (counts[0][v][1] + counts[1][v][1])
        o, b = WK.step_work(pairs, vis, pixels)
        ops, nbytes = ops + o, nbytes + b
    return dict(ops_per_step=ops / (s1 - s0), bytes_per_step=nbytes / (s1 - s0))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str, root: Path = HERE):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fsbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def host_probe_ms() -> float:
    """The time of a fixed pure-Python loop (ms): the host's speed for this
    process, logged beside the window to tell host noise from the program's."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i * i % 7
    return 1e3 * (time.perf_counter() - t0)


def host_state() -> str:
    load = os.getloadavg() if hasattr(os, "getloadavg") else ()
    cpus = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count())
    return (f"host probe {host_probe_ms():.2f} ms, load "
            + " ".join(f"{x:.2f}" for x in load) + f", {cpus} cpus, "
            f"{torch.get_num_threads()} torch threads")


def set_up(workload: str, seed: int, *, device=None, root: Path = HERE,
           shrink: dict | None = None) -> dict:
    """A run's set-up, to the warm boundary: the cell's files, the kernels,
    the scene, the Trainer, and what the reference checks of it (start,
    warm). `device` and `shrink` (deep overrides of "config" and "traffic")
    are for tests on the CPU; without them the run takes the card."""
    cell, config, traffic, bench = load_cell(workload, root)
    if shrink:
        config = merge(config, shrink.get("config", {}))
        traffic = merge(traffic, shrink.get("traffic", {}))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device is available")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['chips']} card(s) asked for, "
                           f"{torch.cuda.device_count()} present")
        from fusionsense_tpu_torch.kernels.build import build_all

        build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = run_config(config, traffic)
    scn = S.make(traffic, sh_degree=cfg["model"]["sh_degree"],
                 init_opacity=cfg["model"]["init_opacity"], seed=seed,
                 device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr, callbacks = build_trainer(cfg, scn, seed, dev)
    start = start_rows(tr, scn["params0"])
    warm = warm_to_boundary(tr, traffic["warm_boundary"], callbacks)
    _sync(dev)
    return dict(cell=cell, bench=bench, cfg=cfg, scn=scn, tr=tr,
                callbacks=callbacks, start=start, warm=warm, dev=dev)


def after_window(tr, callbacks: list, dev) -> dict:
    """Untimed, on from the state the window ended on (just after a refine
    boundary): the checked steps, then the next refine boundary."""
    steps = checked_steps(tr)
    every = tr.cfg.train.adc.refine_every
    boundary = warm_to_boundary(tr, (tr.step // every + 1) * every,
                                callbacks)
    _sync(dev)
    return dict(steps=steps, boundary=boundary)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, root: Path = HERE, shrink: dict | None = None,
             limits: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run -> the result line (a dict). `device`, `shrink` and `limits`
    are for tests on the CPU; a run from the command line always takes the
    card and the cell's limits file."""
    t_start = time.perf_counter() if t_start is None else t_start
    su = set_up(workload, seed, device=device, root=root, shrink=shrink)
    cell, bench, cfg, scn, dev = (su["cell"], su["bench"], su["cfg"],
                                  su["scn"], su["dev"])
    tr, callbacks = su.pop("tr"), su.pop("callbacks")
    prof = profiled_interval(tr, dev, keep=trace)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s, step {tr.step}, "
        f"{int(tr.gaussians.num_alive)} alive, profiled steps "
        f"{prof['kept']['steps']}: busy {1e3 * prof['busy_s']:.3f} ms in "
        f"{prof['profiled_wall_s']:.3f} s; {host_state()}")

    marks = time_boundaries(tr, dev) if trace else None
    win = window(tr, seconds, dev)
    if marks is not None:
        del tr.refine_boundary
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"window {win['window_s']:.3f} s, {win['window_steps']} steps, "
        f"step {tr.step}, {int(tr.gaussians.num_alive)} alive; "
        f"{host_state()}")
    kept = prof.pop("kept")
    raw = dict(setup_s=setup_s, peak_mem_bytes=peak, **win, **prof)
    if trace:
        raw["refine_ms"] = [a.elapsed_time(b) for a, b in marks]
        raw["card"] = card()
        log(f"card: {raw['card']}")
    post = after_window(tr, callbacks, dev)
    log(f"checked steps from {post['steps']['start']['step']}, boundary "
        f"{post['boundary']['step']}")
    del tr, callbacks
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = C.check(su["start"], post["steps"],
                     [su["warm"], post["boundary"]], scn, cfg, seed, dev,
                     C.limits(workload, root) if limits is None else limits)
    if not trace:
        post = su["warm"]["post"]
        rows = torch.nonzero(post["alive"])[:, 0]
        state = {k: post[k][rows].to(dev) for k in post
                 if k not in ("m", "v", "acc", "stats", "alive")}
        raw["psnr_views"] = RR.mean_psnr(state, scn["cams"], scn["images"],
                                         cfg["raster"],
                                         sh_band(cfg["model"],
                                                 su["warm"]["step"]))
    else:
        raw.update(interval_work(kept, cfg, scn, dev))
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        value = load_reader(m["name"], root)(raw)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise RunError("the run loaded " + ", ".join(found))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(0)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": win["window_steps"], "failed": win["failed"],
           "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=raw["busy_s"],
                           window_s=raw["profiled_wall_s"],
                           power_limit=raw["card"])
        out["breakdown"] = raw["breakdown"]
    out["checks"] = checks
    return out

