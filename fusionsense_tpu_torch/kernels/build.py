"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source compiles into its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/fusionsense_tpu_torch/<name>-<hash>.so

at first use, keyed by a hash of the flags, the source and every header
under csrc/ that it includes (directly or through another header), into
build/ at the repository root (listed in .gitignore). Nothing here runs at
import time.

The kernel modules' wrappers share what is here besides: `launch` calls an
entry point, `check` refuses what the kernels cannot take, and each module
keeps its launch counts in one `Launches`, which REGISTRY lists for
train/graphs.py.
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
SOURCES = ("flat_composite", "composite2", "preprocess", "ssim")
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


class Launches:
    """The launch counts of one kernel module. `counts` has one entry per
    kernel entry point, counted once per forward or backward call whatever
    its launches, and one per plain version, counted per call on CPU
    tensors; chip_smoke.py zeroes them before driving a path and reads them
    after it. `captured` counts the calls recorded into a CUDA graph under
    stream capture: the graph runs them at each of its replays, so
    train/graphs.py counts them there, from REGISTRY."""

    def __init__(self, kernels, plain=()):
        self.counts = dict.fromkeys((*kernels, *plain), 0)
        self.captured = dict.fromkeys(kernels, 0)
        REGISTRY.append(self)

    def reset(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    def count(self, key: str) -> None:
        """One call of the entry point `key` (one recording, under capture)."""
        import torch

        (self.captured if torch.cuda.is_current_stream_capturing()
         else self.counts)[key] += 1


REGISTRY: list[Launches] = []      # every kernel module's, in import order


def check(device, *specs) -> None:
    """Raise ValueError unless each spec (name, tensor, dtype, shape) is a
    contiguous tensor of that dtype and shape (None: one element) on
    `device`, and `device` is a CUDA device: what the kernels take. The
    CUDA test comes last, so a host build of a kernel's arithmetic can
    take CPU tensors through every other test."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = "(one element)" if shape is None else tuple(shape)
        if t.numel() != 1 if shape is None else tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not on {device}")
    if device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {device}")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    return ctypes.CDLL(str(build(name).path))


def launch(name: str, entry_points: dict, fn: str, tensors, ints,
           floats=()) -> None:
    """Call the C entry point `fn` of csrc/<name>.cu with the tensors' data
    pointers (None passes a null pointer), then `ints`, then `floats` (as
    C floats), then the current CUDA stream of the first tensor's device,
    and raise if it returns a CUDA error. entry_points maps each entry point
    of the library to its (pointer, int) or (pointer, int, float) argument
    counts; the library is typed from it on first use."""
    import torch

    lib = load(name)
    if not getattr(lib, "_fs_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for ep, (n_ptr, n_int, *n_float) in entry_points.items():
            getattr(lib, ep).argtypes = ([vp] * n_ptr + [ci] * n_int
                                         + [cf] * sum(n_float) + [vp])
            getattr(lib, ep).restype = ci
        lib._fs_typed = True
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    ptrs = (None if t is None else t.data_ptr() for t in tensors)
    err = getattr(lib, fn)(*ptrs, *ints, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
