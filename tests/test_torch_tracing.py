"""The port's spans and pair counters (utils/profiling.py `span`,
train/trainer.py): spans only while a profiler runs, none on the card's
timeline, their counts and nesting over Trainer.run, no new host read, and
the history's pairs_dropped / pairs_truncated against the steps' own
counts. A tiny flat-backend scene on the CPU (3 views at 64x48, tile 16),
refine and log every 4 steps."""
from collections import Counter
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fusionsense_tpu_torch.config import (
    ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
)
from fusionsense_tpu_torch.data.synthetic import (
    ring_cameras, sphere_depth_normals, sphere_points,
)
from fusionsense_tpu_torch.gaussians.adc import ADCConfig
from fusionsense_tpu_torch.gaussians.init import init_from_points
from fusionsense_tpu_torch.render.rasterize import RasterizeConfig
from fusionsense_tpu_torch.train import trainer as TRT
from fusionsense_tpu_torch.utils import profiling as PR

EVERY = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def mini_trainer(tile_capacity=128, auto=True, cover=4):
    cams = ring_cameras(n_views=3, width=64, height_px=48, focal=60.0,
                        device="cpu")
    pts, rgb, normals = sphere_points(n=120, radius=0.5, device="cpu")
    g = init_from_points(pts, rgb, capacity=256, sh_degree=1,
                         seed_normals=normals)
    dn = [sphere_depth_normals(cams.index(i)) for i in range(3)]
    data = TRT.TrainData(images=torch.zeros((3, 48, 64, 3)) + 0.4,
                         sensor_depths=torch.stack([d[0] for d in dn]),
                         normals=torch.stack([d[1] for d in dn]))
    rcfg = RasterizeConfig(tile_size=16, tile_capacity=tile_capacity,
                           max_tiles_per_gaussian=cover, tile_chunk=10,
                           sh_degree=1, backend="flat")
    cfg = ExperimentConfig(
        model=ModelConfig(sh_degree=1, rasterize=rcfg, capacity=256),
        train=TrainConfig(iterations=40, scan_chunk=EVERY, log_every=EVERY,
                          auto_tile_capacity=auto, auto_cover_window=auto,
                          adc=ADCConfig(warmup=EVERY, refine_every=EVERY)),
        loss=LossConfig(sensor_depth_lambda=0.1))
    return TRT.Trainer(cfg, cams, data, g, device="cpu")


def host_events(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def innermost(spans, s, e):
    """The shortest fs.* span holding [s, e], or None."""
    holding = [x for x in spans if x[1] <= s and e <= x[2] and x[1:] != (s, e)]
    return min(holding, key=lambda x: x[2] - x[1])[0] if holding else None


@pytest.fixture(scope="module")
def run_profile():
    """Trainer.run from step 4 over two refine intervals (steps 4-12) under
    a CPU profile, with every tolist call counted."""
    tr = mini_trainer()
    tr.run(iterations=EVERY, log=None)
    calls = []
    tolist = torch.Tensor.tolist

    def counted(self):
        calls.append(self.shape)
        return tolist(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "tolist", counted)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.run(iterations=3 * EVERY, log=None)
    return host_events(prof), calls


def test_span_is_a_shared_null_context_without_a_profiler():
    assert PR.span("fs.x") is PR.span("fs.y", 3) is PR._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        with PR.span("fs.outer", 7):
            with PR.span("fs.inner"):
                torch.ones(4).sum()
    evs = {e.name(): e for e in p.profiler.kineto_results.events()}
    assert {"fs.outer", "fs.inner"} <= set(evs)
    assert evs["fs.outer"].kwinputs() == {"step": 7}
    # a function-scope record: kineto puts no annotation on the card's
    # timeline for it, as it would for record_function's user scope
    assert not evs["fs.outer"].is_user_annotation()
    assert not evs["fs.inner"].is_user_annotation()
    assert PR.span("fs.z") is PR._NO_SPAN


def test_train_loop_spans_count_and_nest(run_profile):
    ev, _ = run_profile
    spans = [x for x in ev if x[0].startswith("fs.")]
    steps = 2 * EVERY
    assert Counter(x[0] for x in spans) == {
        "fs.step": steps, "fs.forward": steps, "fs.project": steps,
        "fs.bin": steps, "fs.composite": steps, "fs.losses": steps,
        "fs.backward": steps, "fs.update": steps, "fs.refine_boundary": 2,
        "fs.log_boundary": 2}
    parent = {"fs.step": None, "fs.refine_boundary": None,
              "fs.log_boundary": None, "fs.forward": "fs.step",
              "fs.backward": "fs.step", "fs.update": "fs.step",
              "fs.project": "fs.forward", "fs.bin": "fs.forward",
              "fs.composite": "fs.forward", "fs.losses": "fs.forward"}
    for name, s, e in spans:
        assert innermost(spans, s, e) == parent[name], name


def test_no_new_host_read(run_profile):
    """The loop reads the card once per log boundary (one tolist of every
    logged scalar, the pair counters among them) and once per recompaction
    (the refine boundary's alive count), as before the counters. The CPU
    stand-ins of K1/K2 read their block counts inside fs.composite and
    fs.backward; the card's kernels do not."""
    ev, tolists = run_profile
    spans = [x for x in ev if x[0].startswith("fs.")]
    reads = Counter(innermost(spans, s, e) for n, s, e in ev
                    if n == "aten::_local_scalar_dense")
    assert reads.pop("fs.refine_boundary") == 2
    assert set(reads) <= {"fs.composite", "fs.backward"}
    assert len(tolists) == 2


def test_pair_counters_are_the_steps_sums(monkeypatch):
    """A pair budget of 8 pairs a tile and a one-tile cover window, both
    held: every step drops and cuts pairs, and each history record holds
    the sums of its steps' overflow and truncated."""
    tr = mini_trainer(tile_capacity=8, auto=False, cover=1)
    per_step = []
    step = TRT.train_step

    def recorded(*a, **k):
        out = step(*a, **k)
        per_step.append((int(out[-1]["overflow"]), int(out[-1]["truncated"])))
        return out

    monkeypatch.setattr(TRT, "train_step", recorded)
    tr.run(iterations=3 * EVERY, log=None)
    assert [h["step"] for h in tr.history] == [4, 8, 12]
    for i, h in enumerate(tr.history):
        chunk = per_step[i * EVERY:(i + 1) * EVERY]
        assert h["pairs_dropped"] == sum(d for d, _ in chunk) > 0
        assert h["pairs_truncated"] == sum(t for _, t in chunk) > 0


def test_device_time_leaves_out_annotations():
    """An annotation row (a user-scope span on the card's timeline) is no
    kernel: device_time sums the kernels' rows only."""
    from torch.autograd import DeviceType

    def row(key, us, count, annotation=False):
        return SimpleNamespace(key=key, device_type=DeviceType.CUDA,
                               self_device_time_total=us, count=count,
                               is_user_annotation=annotation)

    rows = [row("k1", 300.0, 3), row("fs.forward", 5000.0, 1, True),
            row("k2", 700.0, 2),
            SimpleNamespace(key="aten::mul", device_type=DeviceType.CPU,
                            self_device_time_total=0.0, count=4,
                            is_user_annotation=False)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    ms, n, kept = PR.device_time(prof)
    assert (ms, n) == (1.0, 5)
    assert [r.key for r in kept] == ["k2", "k1"]
