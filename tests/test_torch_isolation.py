"""The port stands alone: no module of fusionsense_tpu_torch, nor
chip_smoke.py, bench_torch.py or full_schedule_torch.py, imports jax,
jaxlib, flax or fusionsense_tpu; none imports Pillow, imageio or
scikit-learn at module level, and none imports scikit-learn at all (the
card's machine has none); its entry points run on the card by default and
raise when none is there."""
import ast
from pathlib import Path

import pytest
import torch

from fusionsense_tpu_torch import device as D

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fusionsense_tpu")
FILES = sorted((ROOT / "fusionsense_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
    ROOT / "full_schedule_torch.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _module_level_imports(path: Path):
    """The imports a module runs when it is imported: those outside any
    function body."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif (isinstance(child, ast.ImportFrom) and child.module
                  and not child.level):
                yield child.module
            yield from walk(child)
    yield from walk(ast.parse(path.read_text(), str(path)))


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN      # whole names: fusionsense_tpu_torch is fine


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_pillow_or_sklearn_on_import(path):
    roots = lambda ms: {m.split(".")[0] for m in ms}  # noqa: E731
    assert not roots(_module_level_imports(path)) & {"PIL", "sklearn",
                                                     "imageio"}, path
    assert "sklearn" not in roots(_imports(path)), path


def test_module_level_matcher_skips_function_bodies(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\ntry:\n    import PIL\nexcept ImportError:\n"
                 "    pass\nclass A:\n    import scipy\n"
                 "def g():\n    import sklearn\n")
    assert list(_module_level_imports(f)) == ["numpy", "PIL", "scipy"]
    assert "sklearn" in list(_imports(f))


def test_matcher_uses_whole_module_names():
    assert _forbidden("fusionsense_tpu.render")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("flax.linen")
    assert not _forbidden("fusionsense_tpu_torch.render")


def test_default_device_is_cuda():
    assert D.DEFAULT_DEVICE == "cuda"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        D.resolve_device()
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    assert D.resolve_device("cpu").type == "cpu"


def test_scene_makers_default_to_the_card(monkeypatch):
    from fusionsense_tpu_torch.data.synthetic import ring_cameras, sphere_points

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ring_cameras(n_views=2)
    with pytest.raises(RuntimeError):
        sphere_points(n=10)


def test_random_quats_default_to_the_card(monkeypatch):
    from fusionsense_tpu_torch.core.transforms import random_quats

    gen = torch.Generator().manual_seed(0)
    q = random_quats(64, gen, device="cpu")
    assert q.device.type == "cpu" and q.shape == (64, 4)
    torch.testing.assert_close(torch.linalg.norm(q, dim=-1), torch.ones(64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        random_quats(4, gen)


def test_pipeline_and_cli_default_to_the_card(monkeypatch, tmp_path):
    from fusionsense_tpu_torch.cli import train as CLI
    from fusionsense_tpu_torch.pipeline import (
        PipelineConfig, ReconstructionPipeline,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ReconstructionPipeline(PipelineConfig())
    with pytest.raises(RuntimeError):
        CLI.main(["--data", str(tmp_path), "--mesh"])


def test_mesh_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """fs-mesh, fs-eval, the Poisson solve and full_schedule_torch.py
    resolve their device before touching a file: without a card they
    raise."""
    import sys

    import numpy as np

    from fusionsense_tpu_torch.cli import eval as CLIE
    from fusionsense_tpu_torch.cli import mesh as CLIM
    from fusionsense_tpu_torch.mesh.poisson import poisson_reconstruct

    sys.path.insert(0, str(ROOT))
    import full_schedule_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError):
        CLIM.main(["tsdf", "--checkpoint", missing, "--data", missing])
    with pytest.raises(RuntimeError):
        CLIE.main(["--checkpoint", missing, "--data", missing])
    with pytest.raises(RuntimeError):
        poisson_reconstruct(np.random.RandomState(0).rand(20, 3),
                            np.ones((20, 3)))
    with pytest.raises(RuntimeError):
        full_schedule_torch.main(["--out", str(tmp_path / "o.json")])


def test_render_batch_and_priors_default_to_the_card(monkeypatch, tmp_path):
    """fs-render, run_batch, generate_priors, align_mono_depths, normals
    from depth and each prior net's predictor resolve their device first:
    without a card they raise."""
    import numpy as np

    from fusionsense_tpu_torch.cli import render as CLIR
    from fusionsense_tpu_torch.eval.batch import BatchJob, run_batch
    from fusionsense_tpu_torch.priors import depth_align, mono_priors
    from fusionsense_tpu_torch.priors.depth_anything import (
        DepthAnythingModel, DepthAnything, tiny_da,
    )
    from fusionsense_tpu_torch.priors.dsine import DSINE, DSinePredictor
    from fusionsense_tpu_torch.priors.dsine.model import tiny_dsine
    from fusionsense_tpu_torch.priors.metric3d import (
        Metric3D, Metric3DPredictor, tiny_m3d,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError):
        CLIR.main(["spiral", "--checkpoint", missing, "--data", missing])
    with pytest.raises(RuntimeError):
        run_batch([BatchJob(data_dir=missing)], output_dir=tmp_path / "b")
    assert not (tmp_path / "b").exists()
    with pytest.raises(RuntimeError):
        mono_priors.generate_priors(missing)
    with pytest.raises(RuntimeError):
        depth_align.align_mono_depths(np.ones((1, 4, 4)), np.ones((1, 4, 4)))
    with pytest.raises(RuntimeError):
        mono_priors.NormalsFromDepth().predict_normals_from_depth(
            np.ones((4, 4)), 1.0, 1.0, 2.0, 2.0)
    for make in (lambda: DSinePredictor(DSINE(tiny_dsine())),
                 lambda: DepthAnythingModel(DepthAnything(tiny_da())),
                 lambda: Metric3DPredictor(Metric3D(tiny_m3d()))):
        with pytest.raises(RuntimeError):
            make()


def test_touch_selection_defaults_to_the_card(monkeypatch, tmp_path):
    """fs-touch, next_best_touches, segment_parts, render_views and
    GLIPPredictor resolve their device first: without a card they raise
    before reading a file or moving a weight."""
    import numpy as np

    from fusionsense_tpu_torch.cli import touch as CLIT
    from fusionsense_tpu_torch.detection import GLIPModel, GLIPPredictor
    from fusionsense_tpu_torch.detection.model import tiny_config
    from fusionsense_tpu_torch.detection.tokenizer import WordPieceTokenizer
    from fusionsense_tpu_torch.touch_select import partseg
    from fusionsense_tpu_torch.touch_select.select import next_best_touches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    pts = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    with pytest.raises(RuntimeError):
        CLIT.main(["--mesh", missing, "--high-grad", missing, "--offline"])
    with pytest.raises(RuntimeError):
        CLIT.main(["--mode", "partname", "--offline"])
    with pytest.raises(RuntimeError):
        next_best_touches(missing, missing)
    with pytest.raises(RuntimeError):
        partseg.segment_parts(pts, pts, ["a"], detector=None)
    with pytest.raises(RuntimeError):
        partseg.render_views(pts, pts, n_views=1, size=8)
    with pytest.raises(RuntimeError):
        GLIPPredictor(GLIPModel(tiny_config()), WordPieceTokenizer.toy(["a"]))


def test_omnidata_viewer_and_nerf_default_to_the_card(monkeypatch, tmp_path):
    """The omnidata predictor, fs-viewer and the NeRF baseline's params
    resolve their device first: without a card they raise, fs-viewer before
    reading its model."""
    from fusionsense_tpu_torch.baselines.nerf import NerfConfig, init_params
    from fusionsense_tpu_torch.cli import viewer as CLIV
    from fusionsense_tpu_torch.priors.omnidata import (
        OmnidataNormals, OmnidataPredictor, tiny_omni,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError):
        OmnidataPredictor(OmnidataNormals(tiny_omni()))
    for flag in ("--ply", "--checkpoint"):
        with pytest.raises(RuntimeError):
            CLIV.main([flag, missing, "--port", "0"])
    with pytest.raises(RuntimeError):
        init_params(torch.Generator(), NerfConfig(table_size_log2=4))
