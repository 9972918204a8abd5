"""Tiny sizes of the cells for the CPU, and the card fixture."""
import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

TINY = {"traffic": {"cameras": {"views": 3, "width": 64, "height": 48,
                                "focal": 55.0},
                    "population": {"points": 300}, "warm_boundary": 8},
        "config": {"adc": {"warmup": 4, "refine_every": 4},
                   "train": {"scan_chunk": 4, "log_every": 4,
                             "add_touch_at": 8},
                   "model": {"capacity": 1024},
                   # no tile of the tiny views outgrows K: the dead slots
                   # at the origin share one tile
                   "raster": {"tile_capacity": 2048}}}
TOUCH = {"patches": 2, "points_per_patch": 30, "cap_deg": 20.0}


def tiny(workload: str) -> dict:
    out = copy.deepcopy(TINY)
    if "touch" in workload:
        out["traffic"]["touch"] = dict(TOUCH)
    return out


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
