"""The port stands alone: no module of fusionsense_tpu_torch, nor
chip_smoke.py, imports jax, jaxlib or fusionsense_tpu; its entry points run
on the card by default and raise when none is there."""
import ast
from pathlib import Path

import pytest
import torch

from fusionsense_tpu_torch import device as D

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "fusionsense_tpu")
FILES = sorted((ROOT / "fusionsense_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN      # whole names: fusionsense_tpu_torch is fine


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


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
