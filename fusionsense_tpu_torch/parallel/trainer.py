"""Multi-device training loop: Trainer.run's semantics on a device mesh.

Counterpart of fusionsense_tpu/parallel/trainer.py. It runs the sharded
step (parallel/sharded.py) in chunks with the single-device trainer's host
policies: the ADC refine, capacity bucketing, the render prefix, the
camera optimizer, the auto tile capacity / pair budget / cover window,
the extra callbacks (touch, hull, high-grad), checkpoints, the debug image
grid and the history log. Every rank runs it (one process per rank).

The replicas stay bit-equal. A reduced gradient is the same on every rank,
and so is every decision taken from a reduced metric. The host mutations
are another matter: the refine and the callbacks scatter into the store
(index_put_ / index_add_ with repeated indices is nondeterministic on
CUDA), so after any rank's refine or callback mutated the state, every
rank takes rank 0's store, moments and stats (comm.broadcast_). The
compaction and the capacity resize need no broadcast: each is a stable
argsort of the alive mask and a gather, or a zero pad, and gives the same
permutation on every rank from the same state.

ZeRO-1 keeps each rank's Adam moments as its slot slice along `data`. A
mutation permutes slots, so the moments are gathered over `data` first
(sharded.gather_opt), mutated whole, and cut again (sharded.shard_opt):
the counterpart of the JAX trainer re-pinning its moment shards.

Only rank 0 (`writer`) writes: checkpoints (the moments gathered whole,
train/checkpoint.py's format, which Trainer reads too), the debug grids
and the log.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fusionsense_tpu_torch.config import ExperimentConfig
from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.device import check_on
from fusionsense_tpu_torch.gaussians.adc import init_stats
from fusionsense_tpu_torch.gaussians.resize import (
    compact_train_state, render_bucket,
)
from fusionsense_tpu_torch.gaussians.store import GaussianState
from fusionsense_tpu_torch.parallel import comm
from fusionsense_tpu_torch.parallel.mesh import AXES, Mesh
from fusionsense_tpu_torch.parallel.sharded import (
    gather_opt, make_sharded_train_chunk, shard_opt, tile_block,
)
from fusionsense_tpu_torch.train.optim import init_adam
from fusionsense_tpu_torch.train.trainer import (
    TrainData, Trainer, check_slice, refine_due,
)


class ShardedTrainer:
    """Trainer.run semantics on a Mesh (data x tile x gauss)."""

    def __init__(self, cfg: ExperimentConfig, camera: Camera, data: TrainData,
                 gaussians: GaussianState, mesh: Mesh,
                 scene_scale: float = 1.0, adam_groups: Optional[dict] = None,
                 shard_optimizer: bool = False,
                 extra_callbacks: Optional[list] = None):
        check_slice(cfg)
        self.device = mesh.device
        check_on(self.device, viewmat=camera.viewmat, images=data.images,
                 means=gaussians.means)
        self.cfg = cfg
        self.camera = camera
        self.data = data
        self.mesh = mesh
        self.writer = mesh.rank == 0
        self.n_data = mesh.shape["data"]
        self.shard_optimizer = shard_optimizer and self.n_data > 1
        if self.shard_optimizer:
            assert gaussians.capacity % self.n_data == 0, (
                "ZeRO-1 needs capacity divisible by the data axis")
        # every rank starts from rank 0's state
        self.gaussians = gaussians.replace(
            **{k: v.clone() for k, v in gaussians.fields().items()})
        comm.broadcast_(mesh, list(self.gaussians.fields().values()))
        self.opt = init_adam(self.gaussians.params())
        self.stats = init_stats(gaussians.capacity, self.device)
        self.scene_scale = scene_scale
        self.num_views = data.images.shape[0]
        self.step = 0
        self.history: list[dict] = []
        self.max_capacity = gaussians.capacity
        self.auto_capacity = cfg.train.auto_capacity
        self.extra_callbacks = extra_callbacks or []
        self.checkpoint_dir = None
        self.image_log_dir = None
        self._debug_render = None
        self._adam_groups = adam_groups
        self._counts = None
        z6 = torch.zeros((self.num_views, 6), device=self.device)
        self.cam_state = (z6, init_adam({"cam_delta": z6}))
        rc = cfg.model.rasterize
        self.tile_capacity = rc.tile_capacity
        cap_tiles = rc.max_tiles_per_gaussian
        self.cover_tiles = (min(4, cap_tiles) if cfg.train.auto_cover_window
                            else cap_tiles)
        self._grid_tiles = (-(-camera.width // rc.tile_size)
                            * -(-camera.height // rc.tile_size))
        # the pair budget is per shard: its tile block's tiles
        _, self._budget_tiles, _ = tile_block(self._grid_tiles,
                                              mesh.shape["tile"], 0)
        self.render_n = None
        if cfg.train.render_prefix:
            self._recompact(int(self.gaussians.num_alive))
        self.opt = self._cut(self.opt)

    # the single-device trainer's policies and debug grid, unchanged
    _is_flat = Trainer._is_flat
    _maybe_bump_tile_capacity = Trainer._maybe_bump_tile_capacity
    _maybe_adjust_cover_window = Trainer._maybe_adjust_cover_window
    _maybe_resize_pair_budget = Trainer._maybe_resize_pair_budget
    _dump_debug_grid = Trainer._dump_debug_grid
    _mutate = Trainer._mutate
    _log_boundary = Trainer._log_boundary
    # the sharded step does not sum the pairs dropped or cut over its shards
    COUNTS = ("nonfinite_steps",)

    def _train_chunk(self):
        return make_sharded_train_chunk(
            self.cfg, self.camera, self.data, self.mesh, self._adam_groups,
            shard_optimizer=self.shard_optimizer,
            tile_capacity=self.tile_capacity, cover_tiles=self.cover_tiles,
            render_n=self.render_n)

    def full_opt(self):
        """The whole Adam state: the ZeRO-1 moments gathered over `data`
        (a collective: every rank calls it), else the replicated state."""
        return gather_opt(self.mesh, self.opt) if self.shard_optimizer \
            else self.opt

    def _cut(self, opt_full):
        return shard_opt(self.mesh, opt_full) if self.shard_optimizer \
            else opt_full

    def _state_tensors(self) -> list:
        opt = self.opt
        return (list(self.gaussians.fields().values())
                + [t for tree in (opt.m, opt.v, opt.acc, opt.counts)
                   for t in tree.values()]
                + list(self.stats.fields().values()))

    def _recompact(self, n_alive: int):
        """Alive-first compaction + render-bucket pick, with the
        single-device trainer's hysteresis; the bucket is rounded up to a
        gauss-axis multiple, as the JAX trainer rounds it. self.opt must be
        whole (full_opt) here."""
        self.gaussians, self.opt, self.stats = compact_train_state(
            self.gaussians, self.opt, self.stats)
        want = render_bucket(n_alive, self.gaussians.capacity)
        n_gauss = self.mesh.shape["gauss"]
        want = min(-(-want // n_gauss) * n_gauss, self.gaussians.capacity)
        if (self.render_n is None or want > self.render_n
                or want * 1.5 <= self.render_n
                or want == self.gaussians.capacity):
            self.render_n = want
        else:
            self.render_n = min(self.render_n, self.gaussians.capacity)

    def _cam_indices(self, n: int) -> np.ndarray:
        """(n, n_data) sequential camera schedule: each data index walks the
        view list with a stride offset."""
        base = np.arange(self.step, self.step + n, dtype=np.int32)[:, None]
        off = np.arange(self.n_data, dtype=np.int32)[None, :]
        return (base * self.n_data + off) % self.num_views

    def refine_boundary(self) -> None:
        """The host side between chunks: the ADC refine when due, the extra
        callbacks, the recompact when the alive set can have changed, and
        rank 0's state everywhere after any rank's mutation. The callback
        lists may differ by rank (the writer alone exports and serves the
        viewer); callbacks make no collective. Whether this boundary's
        collectives run is decided over every rank."""
        if not refine_due(self.cfg.train.adc, self.step):
            n_cb = torch.tensor([len(self.extra_callbacks)],
                                device=self.device)
            if not int(comm.pmax(self.mesh, n_cb, AXES)[0]):
                return
        self.opt = self.full_opt()
        _, mutated = self._mutate()
        flag = torch.tensor([int(mutated)], device=self.device)
        if int(comm.pmax(self.mesh, flag, AXES)[0]):
            comm.broadcast_(self.mesh, self._state_tensors())
            if self.cfg.train.render_prefix:
                self._recompact(int(self.gaussians.num_alive))
        self.opt = self._cut(self.opt)

    def save(self, path):
        """Trainer.save's checkpoint, the moments gathered whole, written by
        rank 0; every rank calls it."""
        from fusionsense_tpu_torch.train.checkpoint import save_trainer_state

        opt = self.full_opt()
        if self.writer:
            save_trainer_state(self, path, opt=opt)
        torch.distributed.barrier()

    def restore(self, path):
        """Resume from a Trainer or ShardedTrainer checkpoint (every rank
        reads it); the moments are cut to this rank's slice."""
        from fusionsense_tpu_torch.train.checkpoint import restore_trainer_state

        restore_trainer_state(self, path)
        if self.shard_optimizer:
            assert self.gaussians.capacity % self.n_data == 0, (
                "ZeRO-1 resume needs checkpoint capacity divisible by the "
                "data axis")
        if self.cfg.train.render_prefix:
            self._recompact(int(self.gaussians.num_alive))
        self.opt = self._cut(self.opt)
        return self

    def _run_chunk(self, n: int):
        (self.gaussians, self.opt, self.cam_state, self.stats,
         metrics) = self._train_chunk()(
            self.gaussians, self.opt, self.cam_state, self.stats,
            self.step, self._cam_indices(n))
        self.step += n
        return ({k: v[-1] for k, v in metrics.items()},
                metrics["nonfinite"].sum().reshape(1))

    def _pick_capacity(self, n_alive: int) -> int:
        cap = Trainer._pick_capacity(self, n_alive)
        if self.shard_optimizer and cap % self.n_data:
            return self.gaussians.capacity
        return cap

    def _rebucket(self, n_alive: int):
        """Trainer's log-boundary re-bucketing with the moments whole: the
        resize and the compaction permute slots."""
        if not (self.cfg.train.render_prefix or (
                self.auto_capacity
                and self._pick_capacity(n_alive) != self.gaussians.capacity)):
            return
        self.opt = self.full_opt()
        Trainer._rebucket(self, n_alive)
        self.opt = self._cut(self.opt)

    # Trainer.run's loop on every rank: the metrics are reduced, so every
    # rank reads the same values and takes the same policy decisions; only
    # the writer logs and dumps debug grids
    run = Trainer.run
