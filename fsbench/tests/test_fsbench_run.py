"""A run end to end at a tiny size on the CPU: the result line, the exit
without a card, and `correct` against a timed path broken underneath."""
import json
import math
import subprocess
import sys

import pytest
import torch

from fsbench import correct as C
from fsbench import harness as H
from fsbench.tests.conftest import tiny

SEED = 2 ** 31 + 77      # past 32 signed bits: seeds of a run can be
CELLS = ["dn_splatter_flat.seed30k", "fusionsense_dense.touch_seed30k"]


def run(cell, trace=False, limits=None, seed=SEED):
    shrink = tiny(cell)
    return H.run_cell(cell, seed, 0.5, trace, device="cpu", shrink=shrink,
                      limits=limits)


@pytest.fixture(scope="module")
def sound():
    """Each cell's sound readings at the tiny size, and limits at twice
    them (a floor of 1e-6; 0 for boundary_flags)."""
    out = {}
    for cell in CELLS:
        checks = run(cell, limits={})["checks"]
        out[cell] = {k: (0.0 if k == "boundary_flags"
                         else max(2 * c["value"], 1e-6))
                     for k, c in checks.items()}
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace, sound):
    cell = CELLS[0]
    out = run(cell, trace, sound[cell])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and out["attempted"] % 4 == 0
    bench = json.loads((H.HERE.parent / "BENCHMARK.json").read_text())
    group = bench["per_layer" if trace else "end_to_end"]
    units = {m["name"]: m["unit"] for m in group}
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and math.isfinite(m["value"])
    if trace:
        # no device on the CPU: readers of device spans return nothing
        assert "composite_roofline" not in out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        # no device on the CPU: the card's busy time is not read
        assert set(out["metrics"]) == set(units) - {"device_step_ms"}
    json.dumps(out)
    assert set(out["checks"]) == set(C.NAMES)


def test_command_without_a_card_prints_nothing():
    proc = subprocess.run(
        [sys.executable, str(H.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_unchanged_state_is_caught(monkeypatch, sound):
    """A step that returns its state unchanged."""
    from fusionsense_tpu_torch.train import trainer as T

    real = T.train_step

    def frozen_step(gaussians, opt, cam_state, stats, *a, **kw):
        *_, metrics = real(gaussians, opt, cam_state, stats, *a, **kw)
        return gaussians, opt, cam_state, stats, metrics

    monkeypatch.setattr(T, "train_step", frozen_step)
    cell = CELLS[0]
    out = run(cell, limits=sound[cell])
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_is_caught(monkeypatch, sound, cell):
    """The loss of the top half of the view's pixels, their mean."""
    from fusionsense_tpu_torch.train import trainer as T

    real = T.loss_terms

    def half(out, normals_g, gaussians, cam_i, data, *a, **kw):
        h = out.rgb.shape[0] // 2
        out = out._replace(rgb=out.rgb[:h], depth=out.depth[:h],
                           normal=out.normal[:h], alpha=out.alpha[:h])
        data = T.TrainData(**{k: None if v is None else v[:, :h]
                              for k, v in vars(data).items()})
        return real(out, normals_g, gaussians, cam_i, data, *a, **kw)

    monkeypatch.setattr(T, "loss_terms", half)
    out = run(cell, limits=sound[cell])
    assert out["correct"] is False


def test_refine_left_out_is_caught(monkeypatch, sound):
    """A refine boundary that returns its state unchanged (the published
    ADC thresholds cull at this size)."""
    from fusionsense_tpu_torch.train import trainer as T

    monkeypatch.setattr(T, "refine_at", lambda g, o, st, *a, **k: (g, o, st,
                                                                   {}))
    cell = CELLS[1]
    out = run(cell, limits=sound[cell])
    assert out["correct"] is False
    assert out["checks"]["boundary_flags"]["value"] > 0


def test_fault_after_set_up_is_caught(monkeypatch, sound):
    """A step that returns its state unchanged only once set-up is over:
    the steps checked come after the window."""
    from fusionsense_tpu_torch.train import trainer as T

    real, calls = T.train_step, [0]
    warm = tiny(CELLS[0])["traffic"]["warm_boundary"]

    def late_frozen(gaussians, opt, cam_state, stats, *a, **kw):
        calls[0] += 1
        out = real(gaussians, opt, cam_state, stats, *a, **kw)
        if calls[0] <= warm:
            return out
        return gaussians, opt, cam_state, stats, out[-1]

    monkeypatch.setattr(T, "train_step", late_frozen)
    cell = CELLS[0]
    out = run(cell, limits=sound[cell])
    assert calls[0] > warm
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_binary_opacity_steps_are_followed():
    """Steps in the binary-opacity phase (DN-Splatter's logit surgery at
    the top of each step): the reference does the same surgery, so the
    sound run's gaps stay at rounding. A window of one interval checks
    steps 16-19: at 20 the tiny store outgrows its capacity and the pair
    budget drops pairs for two steps while its policy resizes it, which
    the reference, dropping none, does not follow."""
    cell = CELLS[0]
    shrink = tiny(cell)
    shrink["config"]["model"]["binary_opacity_margin"] = 1
    checks = H.run_cell(cell, SEED, 0.01, False, device="cpu", shrink=shrink,
                        limits={})["checks"]
    assert checks["loss_gap"]["value"] < 1e-4
    assert checks["change_gap"]["value"] < 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_caught(cell):
    """The control (the reference in TF32) against the reference fails a
    number by more than the sound run's reading of it, at this size."""
    from fsbench.calibrate import seed_readings

    r = seed_readings(cell, 3, True, 0.5, device="cpu", shrink=tiny(cell))
    del r["program"]["leaves"], r["control"]["leaves"]
    assert any(r["control"][k] > 3 * r["program"][k] for k in C.NAMES
               if r["program"][k] > 0)


@pytest.mark.parametrize("cell", CELLS)
def test_faults_read_past_the_sound_run(cell):
    """The faults as calibrate.py reads them at a cell's size: half of the
    batch left out and a refine boundary left out each fail a number the
    sound run reads far under."""
    from fsbench.calibrate import seed_readings

    r = seed_readings(cell, 5, True, 0.5, device="cpu", shrink=tiny(cell))
    half, left = r["faults"]["half_batch"], r["faults"]["refine_left_out"]
    assert any(half[k] > 3 * max(r["program"][k], 1e-7) for k in half)
    assert left["boundary_flags"] > 0 == r["program"]["boundary_flags"]


@pytest.mark.gpu
def test_cell_on_the_card(card):
    out = H.run_cell(CELLS[0], SEED, 1.0, False, device=card,
                     shrink=tiny(CELLS[0]), limits={})
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    assert out["metrics"]["device_step_ms"]["value"] > 0
    assert torch.cuda.is_available()
