"""The work counter, the trace reduction and the import rules."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from fsbench import harness as H
from fsbench import trace as TR
from fsbench import work as WK


def test_step_work():
    ops, nbytes = WK.step_work(pairs=1000, visible=10, pixels=4)
    assert ops == 132 * 1000
    assert nbytes == 3 * 4 * (13 * 10 + 8 * 4)
    assert WK.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert WK.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_union_and_idle_gaps():
    ev = {"device": [("k1(float*)", 0, 10), ("k2", 5, 20), ("k1(float*)", 30,
                                                            40),
                     ("memcpy", 45, 50)],
          "host": [("aten::item", 18, 32), ("aten::add", 20, 29),
                   ("python", 0, 100)],
          "launches": 3}
    assert TR.union([(s, e) for _, s, e in ev["device"]]) == [[0, 20],
                                                               [30, 40],
                                                               [45, 50]]
    assert TR.busy_seconds(ev) == pytest.approx(35e-9)
    assert TR.by_kernel(ev)["k1"] == pytest.approx(20e-9)
    gaps = TR.idle_gaps(ev)
    # the 10 ns hole: aten::add overlaps 9, aten::item 10, python 10;
    # the shortest of the best overlap wins
    assert gaps[0] == ["aten::item", pytest.approx(10e-9)]
    assert gaps[1][1] == pytest.approx(5e-9)
    assert TR.top_kernels(ev)[0][0] == "k1"


def test_idle_share_over_the_unprofiled_step():
    """Busy 6 ms a step by the trace, 10 ms a step in the unprofiled
    window: 40% idle, however long the profiled steps took."""
    raw = dict(busy_s=0.6, profiled_steps=100, profiled_wall_s=2.0,
               window_s=30.0, window_steps=3000)
    assert H.load_reader("device_idle_share")(raw) == pytest.approx(40.0)
    assert H.load_reader("device_idle_share")({}) is None


def test_device_step_and_mfu_over_the_busy_step():
    """Busy 6 ms a step by the trace, whatever the window's wall step:
    device_step_ms 6; 6.7e8 counted operations a step at 67 TFLOP/s take
    10 us, 1/600 of the busy step; no device intervals, no reading."""
    raw = dict(busy_s=0.6, profiled_steps=100, window_s=30.0,
               window_steps=3000, ops_per_step=6.7e8)
    assert H.load_reader("device_step_ms")(raw) == pytest.approx(6.0)
    assert H.load_reader("step_mfu")(raw) == pytest.approx(100 / 600)
    raw["busy_s"] = 0.0
    assert H.load_reader("device_step_ms")(raw) is None
    assert H.load_reader("step_mfu")(raw) is None


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    files = list((H.HERE / "reference").glob("*.py")) + [H.HERE / "scene.py"]
    for f in files:
        assert not _imports(f) & {"fusionsense_tpu_torch", *H.FORBIDDEN}, f


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fusionsense_tpu_torch_fake.x", None)
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "optax.tree", None)
    assert H.forbidden_modules() == ["optax"]


def test_a_run_loads_no_jax():
    """Every module a run imports, in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, %r);"
            "import fsbench.harness as H, fsbench.calibrate;"
            "from fusionsense_tpu_torch.train import trainer;"
            "from fusionsense_tpu_torch.kernels import build;"
            "[H.load_reader(m) for m in ('composite_roofline', 'step_mfu')];"
            "print(H.forbidden_modules())" % str(H.HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
