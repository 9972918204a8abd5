"""The port stands alone: no module of fusionsense_tpu_torch, nor
chip_smoke.py or bench_torch.py, imports jax, jaxlib or fusionsense_tpu; none imports Pillow
or scikit-learn at module level, and none imports scikit-learn at all (the
card's machine has none); its entry points run on the card by default and
raise when none is there."""
import ast
from pathlib import Path

import pytest
import torch

from fusionsense_tpu_torch import device as D

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fusionsense_tpu")
FILES = sorted((ROOT / "fusionsense_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]


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
    assert not roots(_module_level_imports(path)) & {"PIL", "sklearn"}, path
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
