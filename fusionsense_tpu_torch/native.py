"""The repository's native superpoint solvers (native/cutpursuit.cpp),
built with g++ and loaded with ctypes.

Counterpart of fusionsense_tpu/native/__init__.py, with the same C
signatures and the same compiler flags:

    g++ -O3 -shared -fPIC -std=c++17 -o build/fusionsense_tpu_torch/cutpursuit-<hash>.so native/cutpursuit.cpp

at first use, keyed by a hash of the flags and the source, into build/ at
the repository root (listed in .gitignore); nothing is written into
native/. A failed build or load raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from fusionsense_tpu_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "cutpursuit.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _target() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_DIR / f"cutpursuit-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/cutpursuit.cpp unless it is built already."""
    so = _target()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, so)        # atomic: concurrent builds never clash
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded solver library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    for fn in (lib.fh_segment, lib.cutpursuit):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, f32p,
                       u32p, u32p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_int, i32p]
    return lib


def _call(fn: str, feats, src, dst, edge_w, param: float, iters: int):
    lib = load()
    feats = np.ascontiguousarray(feats, np.float32)
    src = np.ascontiguousarray(src, np.uint32)
    dst = np.ascontiguousarray(dst, np.uint32)
    n, d = feats.shape
    labels = np.empty(n, np.int32)
    # keep the converted weights alive past the C call (the pointer of a
    # temporary would dangle when edge_w needs conversion)
    ew = (np.ascontiguousarray(edge_w, np.float32)
          if edge_w is not None else None)
    w_ptr = ew.ctypes.data if ew is not None else None
    getattr(lib, fn)(n, d, len(src), feats, src, dst, w_ptr,
                     np.float32(param), iters, labels)
    return labels.astype(np.int64)


def fh_segment(feats: np.ndarray, src: np.ndarray, dst: np.ndarray,
               edge_w: np.ndarray | None = None, k: float = 0.05,
               min_size: int = 10) -> np.ndarray:
    """Felzenszwalb-Huttenlocher graph segmentation. Returns (N,) labels."""
    return _call("fh_segment", feats, src, dst, edge_w, k, min_size)


def cutpursuit(feats: np.ndarray, src: np.ndarray, dst: np.ndarray,
               edge_w: np.ndarray | None = None, reg: float = 0.05,
               max_iter: int = 10) -> np.ndarray:
    """L0 cut-pursuit partition (the reference's libcp.cutpursuit slot,
    PartSlip/src/gen_superpoint.py:15,65). Returns (N,) labels."""
    return _call("cutpursuit", feats, src, dst, edge_w, reg, max_iter)
