"""Device mesh and rank bootstrap for multi-device training.

Counterpart of fusionsense_tpu/parallel/mesh.py. The JAX package runs one
SPMD program over a jax.sharding.Mesh; here every rank is a process of its
own (one per device, as torchrun starts them) and the mesh is a
torch.distributed DeviceMesh over the process group, with the JAX axes:

- "data": cameras (gradients psum over it: the DDP analog);
- "tile": image tiles inside the rasterizer;
- "gauss": per-camera log-depth slices of the Gaussians, merged front to
  back (out = sum_g T_{<g} out_g; parallel/sharded.py).

Ranks are laid out row-major over (data, tile, gauss), as
init_device_mesh lays them out. Parameters stay replicated on every rank;
ZeRO-1 (parallel/sharded.py) shards the Adam moments along `data`.

Bootstrap. make_mesh uses the current process group when one exists (a
launcher's, or one the caller started with init_ranks). Otherwise it reads
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) and
starts the group with init_method "env://"; with no launcher and a mesh of
one rank it starts a world of one in this process. A mesh of more than one
rank with no launcher raises and says how to launch: it never trains
single-process quietly. Each rank's device is chosen explicitly: the CPU
when the caller asks for it, else cuda:{LOCAL_RANK % device_count}.

Backend rule (fixed, printed once per run by rank 0):
- nccl when every rank of the host has a card of its own (the device is
  CUDA and LOCAL_WORLD_SIZE <= torch.cuda.device_count());
- gloo when ranks share a card or run on the CPU. NCCL refuses two ranks
  on one card ("Duplicate GPU detected"); gloo takes CUDA tensors and moves
  them through host memory itself.
Nothing switches backend after a failure: a failed init raises.
"""
from __future__ import annotations

import itertools
import os
from typing import Optional

import torch
import torch.distributed as dist

from fusionsense_tpu_torch.device import resolve_device

AXES = ("data", "tile", "gauss")
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def parse_axes(spec: str) -> dict:
    """"data=2,tile=2,gauss=2" -> {"data": 2, "tile": 2, "gauss": 2}, as the
    JAX pipeline parses --device-mesh."""
    axes = dict(kv.split("=") for kv in spec.split(","))
    axes = {k.strip(): int(v) for k, v in axes.items()}
    unknown = set(axes) - set(AXES)
    if unknown:
        raise ValueError(f"--device-mesh {spec!r}: unknown axes "
                         f"{sorted(unknown)}; the axes are {AXES}")
    return axes


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _launched() -> bool:
    return all(k in os.environ for k in _LAUNCHER_ENV)


def world_size() -> int:
    """The ranks of the current group, or those a launcher announced, or 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1) if _launched() else 1


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else the card
    LOCAL_RANK % device_count."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", _env_int("LOCAL_RANK", 0)
                        % torch.cuda.device_count())


def backend_for(dev: torch.device) -> tuple[str, str]:
    """(backend, reason) by the module's rule."""
    local = _env_int("LOCAL_WORLD_SIZE", world_size())
    if dev.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl", f"{local} rank(s) per host, each on a card of its own"
    if dev.type == "cuda":
        return "gloo", (f"{local} ranks share {torch.cuda.device_count()} "
                        "card(s); NCCL takes one rank per card")
    return "gloo", "ranks on the CPU"


def init_ranks(device=None, init_method: str = "env://") -> torch.device:
    """Start this process's rank of the group (RANK and WORLD_SIZE from the
    environment) on its device, with the backend of the module's rule;
    returns the device. init_method "env://" is torchrun's rendezvous; a
    "file://" URL serves callers that start the ranks themselves."""
    dev = rank_device(device)
    backend, why = backend_for(dev)
    rank, size = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, **kw)
    if rank == 0:
        print(f"fusionsense_tpu_torch.parallel: {size} rank(s) on "
              f"{dev.type}, backend {backend} ({why})", flush=True)
    return dev


def _init_world_of_one(device) -> torch.device:
    dev = rank_device(device)
    backend, why = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    print(f"fusionsense_tpu_torch.parallel: 1 rank on {dev.type}, backend "
          f"{backend} ({why})", flush=True)
    return dev


class Mesh:
    """The (data, tile, gauss) mesh over the whole process group: the
    DeviceMesh, this rank's device and coordinates, and a process group for
    every set of axes (None where the set spans one rank).

    shape and coords are dicts keyed by axis, as jax's Mesh.shape and
    lax.axis_index give them."""

    def __init__(self, data: int, tile: int, gauss: int, dev: torch.device):
        from torch.distributed.device_mesh import init_device_mesh

        self.shape = {"data": data, "tile": tile, "gauss": gauss}
        self.device = dev
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device_mesh = init_device_mesh(dev.type, (data, tile, gauss),
                                            mesh_dim_names=AXES)
        d, rem = divmod(self.rank, tile * gauss)
        self.coords = {"data": d, "tile": rem // gauss, "gauss": rem % gauss}
        # one group per set of axes; every rank creates every group in the
        # same order (torch.distributed.new_group's contract)
        self._groups = {}
        for r in range(1, len(AXES) + 1):
            for axes in itertools.combinations(AXES, r):
                self._groups[axes] = self._make_group(axes)

    def _make_group(self, axes):
        if self.size_of(axes) == 1:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if self.size_of(axes) == self.size:
            return dist.group.WORLD
        mine = None
        others = [a for a in AXES if a not in axes]
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = []
            for free in itertools.product(*(range(self.shape[a]) for a in axes)):
                c = {**at, **dict(zip(axes, free))}
                ranks.append((c["data"] * self.shape["tile"] + c["tile"])
                             * self.shape["gauss"] + c["gauss"])
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    @staticmethod
    def _key(axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in AXES if a in axes)

    def size_of(self, axes) -> int:
        n = 1
        for a in self._key(axes):
            n *= self.shape[a]
        return n

    def group(self, axes):
        """The process group spanning `axes` (a name or names) through this
        rank, or None where it is this rank alone."""
        return self._groups[self._key(axes)]

    def close(self) -> None:
        """Wait for every rank, then end the process group."""
        dist.barrier()
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              tile: int = 1, gauss: int = 1, *, device=None) -> Mesh:
    """A (data, tile, gauss) Mesh over every rank of the group (the JAX
    signature; data defaults to n // (tile * gauss)). The product must equal
    the world size, which is checked before any group is started."""
    n = n_devices or world_size()
    if data is None:
        data = n // (tile * gauss)
    assert data * tile * gauss == n, \
        f"mesh {data}x{tile}x{gauss} != {n} devices"
    if n > 1 and not (dist.is_initialized() or _launched()):
        raise RuntimeError(
            f"a mesh of {n} ranks needs one process per rank: launch with "
            f"torchrun --nproc-per-node {n} -m fusionsense_tpu_torch.cli.train"
            " ... --device-mesh ..., or start the ranks and call "
            "parallel.mesh.init_ranks in each")
    if n != world_size():
        raise ValueError(
            f"a mesh of {n} ranks in a world of {world_size()}: start one "
            f"process per rank (torchrun --nproc-per-node {n} ...)")
    if dist.is_initialized():
        dev = rank_device(device)
    elif _launched():
        dev = init_ranks(device)
    else:
        dev = _init_world_of_one(device)
    return Mesh(data, tile, gauss, dev)
