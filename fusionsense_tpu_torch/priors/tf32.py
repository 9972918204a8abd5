"""Full float32 for the prior nets on the card.

cuDNN runs float32 convolutions in TF32 on Hopper unless told not to
(torch.backends.cudnn.allow_tf32 defaults to True), and matmuls do so too
where a program allows it (torch.backends.cuda.matmul.allow_tf32, or
torch.set_float32_matmul_precision("high")). The predictors run their nets
inside `full_float32()`, so neither flag moves a prior: the convolutions
and the ViTs' linear layers, attention and resize matmuls all run in full
float32. chip_smoke.py measures what TF32 would move (PERF.md). Nothing
here changes a flag outside the context.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and CUDA matmuls without TF32 inside the context,
    the other cuDNN settings as they are; the matmul flag restored on
    exit."""
    b, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    matmul = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        with b.flags(enabled=b.enabled, benchmark=b.benchmark,
                     deterministic=b.deterministic, allow_tf32=False):
            yield
    finally:
        mm.allow_tf32 = matmul
