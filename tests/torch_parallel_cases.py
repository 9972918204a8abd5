"""Jobs the port's multi-device tests run on every rank of a
torch_parallel_world.World (gloo on the CPU). Each takes numpy inputs and
returns numpy results; nothing here imports JAX."""
from __future__ import annotations

import numpy as np
import torch

from fusionsense_tpu_torch import convert
from fusionsense_tpu_torch.gaussians.adc import init_stats
from fusionsense_tpu_torch.parallel.mesh import make_mesh
from fusionsense_tpu_torch.parallel.sharded import (
    gather_opt, make_sharded_train_step, shard_opt,
)
from fusionsense_tpu_torch.train.optim import adam_step, init_adam
from fusionsense_tpu_torch.train.trainer import compute_losses


def _np(x):
    return x.detach().cpu().numpy()


def _tree(d: dict) -> dict:
    return {k: _np(v) for k, v in d.items()}


def scene_of(scene: dict):
    """(Camera, TrainData) on the CPU from the numpy scene."""
    return (convert.camera_from_numpy(scene["camera"], "cpu"),
            convert.train_data_from_numpy(scene["data"], "cpu"))


def cam_state(n_views: int):
    z6 = torch.zeros((n_views, 6))
    return z6, init_adam({"cam_delta": z6})


def batch_mean_step(cams, data, g, cfg, views):
    """The single-device reference: Adam on the mean of the views'
    gradients of compute_losses, from a fresh optimiser at step 0."""
    grads = None
    for i in views:
        params = {k: v.detach().requires_grad_(True)
                  for k, v in g.params().items()}
        tap = torch.zeros((g.capacity, 2), requires_grad=True)
        total, _ = compute_losses(g.replace(**params), cams, data, int(i), 0,
                                  cfg, tap)
        gi = dict(zip(params, torch.autograd.grad(
            total, list(params.values()), allow_unused=True)))
        gi = {k: torch.zeros_like(params[k]) if v is None else v
              for k, v in gi.items()}
        grads = gi if grads is None else {k: grads[k] + gi[k] for k in gi}
    grads = {k: v / len(views) for k, v in grads.items()}
    params, opt = adam_step(g.params(), grads, init_adam(g.params()), 0,
                            g.alive)
    return {"params": _tree(params), "m": _tree(opt.m)}


def sharded_step(scene, cfg, axes, init, cam_indices, shard_optimizer=False,
                 reference=False):
    """One make_sharded_train_step step on the mesh `axes` from `init`
    (a fresh optimiser and stats). Every rank returns its params, its
    gathered moments, stats and metrics; with `reference`, rank 0 adds the
    single-device batch-mean step over the same cameras."""
    mesh = make_mesh(**axes, device="cpu")
    cams, data = scene_of(scene)
    g = convert.state_from_numpy(init, "cpu")
    opt = init_adam(g.params())
    if shard_optimizer:
        opt = shard_opt(mesh, opt)
    step = make_sharded_train_step(cfg, cams, data, mesh,
                                   shard_optimizer=shard_optimizer)
    g2, opt2, _, st2, metrics = step(
        g, opt, cam_state(data.images.shape[0]), init_stats(g.capacity, "cpu"),
        0, np.asarray(cam_indices))
    if shard_optimizer:
        opt2 = gather_opt(mesh, opt2)
    out = {"params": _tree(g2.params()), "m": _tree(opt2.m),
           "v": _tree(opt2.v), "stats": _tree(st2.fields()),
           "metrics": _tree(metrics)}
    if reference and mesh.rank == 0:
        out["ref"] = batch_mean_step(cams, data, g, cfg, cam_indices)
    return out


def single_step_stats(scene, cfg, init, view):
    """The single-device train_step at `view` (one call, fresh state): its
    refine stats (the absgrad accumulator)."""
    from fusionsense_tpu_torch.train.trainer import patched_cfg, train_step

    cams, data = scene_of(scene)
    g = convert.state_from_numpy(init, "cpu")
    _, _, _, st, _ = train_step(
        g, init_adam(g.params()), cam_state(data.images.shape[0]),
        init_stats(g.capacity, "cpu"), 0, view, cfg=patched_cfg(cfg),
        camera=cams, data=data)
    return _tree(st.fields())


def _checksums(tr) -> dict:
    """Each state tensor as bytes, for bit-equality across ranks."""
    opt = tr.full_opt()
    out = {f"g.{k}": _np(v).tobytes() for k, v in tr.gaussians.fields().items()}
    for name, tree in (("m", opt.m), ("v", opt.v), ("acc", opt.acc)):
        out.update({f"{name}.{k}": _np(v).tobytes() for k, v in tree.items()})
    out.update({f"stats.{k}": _np(v).tobytes()
                for k, v in tr.stats.fields().items()})
    return out


def use_split_noise(noise: dict) -> None:
    """Make the refine draw its split normals from `noise` ({generator seed:
    (n, capacity, 3) array}, the draws of the JAX trainer's keys for those
    seeds) in this process."""
    from fusionsense_tpu_torch.train import trainer as TRT

    def draw(generator, n, capacity, device=None):
        return torch.as_tensor(noise[generator.initial_seed()], device=device)
    TRT.split_noise = draw


def sharded_trainer(scene, cfg, axes, init, shard_optimizer=True,
                    iterations=None, save=None, restore=None, patches=None,
                    single=False, noise=None):
    """ShardedTrainer on the mesh `axes` from `init`: restored from
    `restore` first when given, run to `iterations`, saved to `save` when
    given. `patches` (numpy TouchPatch fields) anchors them by the touch
    callback at cfg.train.add_touch_at; `noise` (use_split_noise) gives
    the refines their split normals. Every rank returns its history,
    render_n, K / pair budget, cover window, step, the population, the
    state's bytes and its params and gathered moments; with `single`, rank
    0 also runs the single-device Trainer on the same inputs and returns
    its history."""
    from fusionsense_tpu_torch.parallel.trainer import ShardedTrainer
    from fusionsense_tpu_torch.train.trainer import Trainer

    if noise is not None:
        use_split_noise(noise)
    mesh = make_mesh(**axes, device="cpu")
    cams, data = scene_of(scene)

    def make_callbacks():
        if patches is None:
            return []
        from fusionsense_tpu_torch.gaussians.touch import (
            add_touch_patches, touch_prune,
        )

        state = {"added": False, "boxes": None}
        pts = convert.touch_patches_from_numpy(patches)

        def cb(tr):
            if not state["added"] and tr.step >= cfg.train.add_touch_at:
                tr.gaussians, tr.opt, state["boxes"] = add_touch_patches(
                    tr.gaussians, tr.opt, pts, gel_scale=1.0,
                    scene_scale=1.0)
                state["added"] = True
                return True
            if state["added"]:
                tr.gaussians = touch_prune(tr.gaussians, state["boxes"])
                return True
            return False
        return [cb]

    tr = ShardedTrainer(cfg, cams, data, convert.state_from_numpy(init, "cpu"),
                        mesh, shard_optimizer=shard_optimizer,
                        extra_callbacks=make_callbacks())
    render_n0 = tr.render_n
    if restore is not None:
        tr.restore(restore)
    restored_means = _np(tr.gaussians.means)
    tr.run(iterations=iterations, log=None)
    if save is not None:
        tr.save(save)
    out = {"history": tr.history, "render_n0": render_n0,
           "render_n": tr.render_n, "step": tr.step,
           "num_alive": int(tr.gaussians.num_alive),
           "frozen": int((tr.gaussians.frozen & tr.gaussians.alive).sum()),
           "frozen_min_op": float(torch.sigmoid(
               tr.gaussians.logit_opacities[tr.gaussians.frozen]).min())
           if bool(tr.gaussians.frozen.any()) else None,
           "restored_means": restored_means, "bytes": _checksums(tr),
           "tile_capacity": tr.tile_capacity, "cover_tiles": tr.cover_tiles,
           "params": _tree(tr.gaussians.params()),
           "m": _tree(tr.full_opt().m), "v": _tree(tr.full_opt().v)}
    if single and mesh.rank == 0:
        t1 = Trainer(cfg, cams, data, convert.state_from_numpy(init, "cpu"),
                     extra_callbacks=make_callbacks(), device="cpu")
        out["render_n_single"] = t1.render_n
        out["single"] = t1.run(log=None)
    return out


def restore_single(scene, cfg, init, path, iterations):
    """A single-device Trainer restored from `path` and run to
    `iterations` -> (step after the restore, history)."""
    from fusionsense_tpu_torch.train.trainer import Trainer

    cams, data = scene_of(scene)
    tr = Trainer(cfg, cams, data, convert.state_from_numpy(init, "cpu"),
                 device="cpu")
    tr.restore(path)
    step = tr.step
    return step, tr.run(iterations=iterations, log=None)


def pipeline_run(argv, out_root, hull_voxel=0.02):
    """fs-train on this rank (main(argv, device="cpu")) with its own
    --output-dir under out_root and a coarse visual-hull grid: the rank,
    its history, its output directory's files and its state's bytes."""
    import functools
    import os

    import fusionsense_tpu_torch.pipeline as pipeline
    from fusionsense_tpu_torch.cli import train as cli
    from fusionsense_tpu_torch.priors import visual_hull as vh

    pipeline.visual_hull = functools.partial(
        vh.visual_hull, cfg=vh.VisualHullConfig(voxel_size=hull_voxel))
    rank = torch.distributed.get_rank()
    pipe = cli.main([*argv, "--output-dir", f"{out_root}/rank{rank}"],
                    device="cpu")
    return {"rank": pipe.mesh.rank,
            "history": [{k: v for k, v in h.items() if k != "elapsed_s"}
                        for h in pipe.trainer.history],
            "files": sorted(os.listdir(pipe.out)),
            "bytes": _checksums(pipe.trainer)}
