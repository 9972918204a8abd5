"""The harness finds configurations, traffic and metric readers by name."""
import dataclasses
import json
import shutil

import pytest

from fsbench import harness as H

BENCH = json.loads((H.HERE.parent / "BENCHMARK.json").read_text())


LISTED = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", LISTED + ["fusionsense_dense.touch_seed30k"])
def test_every_cell_loads(cell):
    entry, config, traffic, bench = H.load_cell(cell)
    assert entry["config"] == config["name"]
    # a cell kept as files for later has no limits yet
    assert (H.HERE / "limits" / f"{cell}.json").exists() == (cell in LISTED)
    cfg = H.run_config(config, traffic)
    ec, groups = H.experiment(cfg, seed=2 ** 31 + 5)
    assert ec.train.seed == 5 and set(groups) == set(cfg["optimizer"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(H.load_reader(metric))


@pytest.mark.parametrize("name,preset,backend", [
    ("dn_splatter_flat", "dn_splatter", "flat"),
    ("fusionsense_dense", "fusionsense", "pallas")])
def test_config_is_the_preset_but_for_reduced(name, preset, backend):
    from fusionsense_tpu_torch import presets
    from fusionsense_tpu_torch.train.optim import DEFAULT_GROUPS

    config = json.loads((H.HERE / "configs" / f"{name}.json").read_text())
    ec, groups = H.experiment(H.run_config(config, {}), seed=0)
    want = getattr(presets, preset)(backend)
    flat = {}
    for group, obj in (("model", ec.model), ("raster", ec.model.rasterize),
                       ("train", ec.train), ("adc", ec.train.adc),
                       ("loss", ec.loss)):
        ref = {"model": want.model, "raster": want.model.rasterize,
               "train": want.train, "adc": want.train.adc,
               "loss": want.loss}[group]
        for f in dataclasses.fields(obj):
            if f.name in ("rasterize", "adc", "seed"):
                continue
            if getattr(obj, f.name) != getattr(ref, f.name):
                flat[f.name] = (getattr(obj, f.name), getattr(ref, f.name))
    assert set(flat) <= set(config["reduced"]), flat
    assert groups == DEFAULT_GROUPS


def test_a_cell_added_as_files(tmp_path):
    """A new traffic mix and a new metric reader join by name alone."""
    root = tmp_path / "fsbench"
    shutil.copytree(H.HERE, root, ignore=shutil.ignore_patterns("tests",
                                                                "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((root / "traffic" / "seed30k.json").read_text())
    traffic["population"]["points"] = 20_000
    (root / "traffic" / "seed20k.json").write_text(json.dumps(traffic))
    (root / "metrics" / "alive_after.py").write_text(
        "def read(raw):\n    return raw.get('alive_after')\n")
    bench["workloads"].append({"name": "dn_splatter_flat.seed20k",
                               "config": "dn_splatter_flat",
                               "traffic": "seed20k", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    entry, config, traffic2, _ = H.load_cell("dn_splatter_flat.seed20k", root)
    assert traffic2["population"]["points"] == 20_000
    assert H.load_reader("alive_after", root)({"alive_after": 3}) == 3
