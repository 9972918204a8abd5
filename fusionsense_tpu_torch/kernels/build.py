"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source compiles into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/fusionsense_tpu_torch/<name>-<hash>.so

at first use, keyed by a hash of the flags, the source and every header
under csrc/ that it includes (directly or through another header), into
build/ at the repository root (listed in .gitignore). Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "fusionsense_tpu_torch"
SOURCES = ("flat_composite", "composite2")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    log: str           # nvcc's output, with ptxas's register/smem report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _inputs(name: str) -> list[Path]:
    """csrc/<name>.cu and every csrc header it includes, transitively."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = path.parent / inc
            if dep.exists():
                todo.append(dep)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Built:
    """Compile csrc/<name>.cu unless it is built already."""
    so = _target(name)
    log = so.with_suffix(".log")
    if so.exists():
        return Built(name, so, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, so)        # atomic: concurrent builds never clash
    return Built(name, so, proc.stdout)


def build_all(names=SOURCES) -> list[Built]:
    """Build the given sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    return ctypes.CDLL(str(build(name).path))


def launch(name: str, entry_points: dict, fn: str, tensors, ints) -> None:
    """Call the C entry point `fn` of csrc/<name>.cu with the tensors' data
    pointers, then `ints`, then the current CUDA stream of the first
    tensor's device, and raise if it returns a CUDA error. entry_points
    maps each entry point of the library to its (pointer, int) argument
    counts; the library is typed from it on first use."""
    import torch

    lib = load(name)
    if not getattr(lib, "_fs_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for ep, (n_ptr, n_int) in entry_points.items():
            getattr(lib, ep).argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
            getattr(lib, ep).restype = ci
        lib._fs_typed = True
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    err = getattr(lib, fn)(*(t.data_ptr() for t in tensors), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
