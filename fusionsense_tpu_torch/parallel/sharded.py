"""Multi-device SPMD training step: data-parallel cameras x tile-parallel
rasterization x depth-sliced Gaussian shards, one rank per process.

Counterpart of fusionsense_tpu/parallel/sharded.py (shard_map there). Every
rank holds the whole replicated store and runs this step on its own
(data, tile, gauss) coordinates; the collectives are written out
(parallel/comm.py):
- "tile": a rank composites only its block of T_loc image tiles from
  tile_lo = me * T_loc (render/rasterize.py render_tiles); the blocks
  all_gather into the full image for the windowed losses (SSIM crosses
  tile borders);
- "gauss": a rank keeps only the Gaussians in its slice of the camera's
  log-depth range; the slices merge front to back, out = sum_g T_{<g}
  out_g and log T = sum_g log T_g, which is exact;
- "data": one camera per data index. Parameter gradients psum over the
  shard axes and pmean over data, as the reference's DDP all-reduce does
  over its batch (reference dn_splatter/dn_pipeline.py:161-167). With
  ZeRO-1 the gradients reduce-scatter over `data` along the Gaussian-slot
  axis, each rank's Adam moments hold its slot slice only, and the fresh
  parameters all_gather back.

The full-image loss runs on every (tile, gauss) member alike, and the
gathers' backward sums the members' cotangents, so each rank's loss is the
true loss / (n_tile * n_gauss): the psum over the shard axes then gives
the exact per-camera gradient both through the gathered image and through
the direct parameter paths (flatness), as in the reference.

After the backward one SUM over all ranks carries the parameter gradients
(the tap and pose-delta gradients, loss, psnr and the non-finite votes with
them; under ZeRO-1 the parameter gradients go by reduce-scatter instead),
one SUM over `data` the overflow count and one MAX over all ranks the
radii and the binning telemetry. Projection and binning are replicated:
O(N) vector math and a sort, next to the O(T * P * K) compositing that
shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from fusionsense_tpu_torch.config import ExperimentConfig
from fusionsense_tpu_torch.core.cameras import Camera, pick
from fusionsense_tpu_torch.device import device_vector
from fusionsense_tpu_torch.gaussians.adc import RefineStats, accumulate_stats
from fusionsense_tpu_torch.gaussians.store import binary_opacity_surgery
from fusionsense_tpu_torch.parallel import comm
from fusionsense_tpu_torch.parallel.mesh import AXES, Mesh
from fusionsense_tpu_torch.render import rasterize as R
from fusionsense_tpu_torch.render.composite import TileGrid
from fusionsense_tpu_torch.render.preprocess import Prepared
from fusionsense_tpu_torch.train.optim import DEFAULT_GROUPS, AdamState, adam_step
from fusionsense_tpu_torch.train.trainer import (
    TrainData, _keep_adam, camera_group, loss_terms, patched_cfg, view_inputs,
)

SHARD_AXES = ("tile", "gauss")


def tile_block(num_tiles: int, n_shards: int, me: int):
    """(T_pad, T_loc, tile_lo) of shard `me`: the tiles padded to a multiple
    of the shard count, each shard's block and its first global tile."""
    T_pad = -(-num_tiles // n_shards) * n_shards
    T_loc = T_pad // n_shards
    return T_pad, T_loc, me * T_loc


def _depth_slice(pre: Prepared, mesh: Mesh) -> Prepared:
    """pre with only this rank's slice of the camera's log-depth range live
    (its valid flags and, for binning, its radii): front-to-back order
    across slices is exact, so out = sum_g T_{<g} out_g."""
    proj = pre.proj
    n_gauss, gme = mesh.shape["gauss"], mesh.coords["gauss"]
    big = torch.full((), 3.4e38, device=proj.depth.device)
    logd = torch.log(torch.clamp_min(proj.depth, 1e-12))
    lo = torch.min(torch.where(proj.valid, logd, big))
    hi = torch.max(torch.where(proj.valid, logd, -big))
    span = torch.clamp_min(hi - lo, 1e-9)
    f0 = lo + span * float(gme) / n_gauss
    f1 = lo + span * float(gme + 1) / n_gauss
    in_slice = (logd >= f0) & ((logd < f1) | (gme == n_gauss - 1))
    valid = proj.valid & in_slice
    radius = torch.where(valid, proj.radius, torch.zeros_like(proj.radius))
    return pre._replace(proj=proj._replace(valid=valid, radius=radius))


def _sharded_losses(gaussians, camera, data: TrainData, cam_idx, step,
                    cfg: ExperimentConfig, tap, mesh: Mesh, cam_delta=None,
                    render_n=None, abs_tap=None):
    """This rank's share of the camera's loss: true loss / (n_tile *
    n_gauss), and (radius, psnr, overflow, trunc_by_win, pairs_used). The
    rank renders only its tile block, restricted to its depth slice of the
    Gaussians when the gauss axis has more than one member."""
    mc = cfg.model
    rcfg = mc.rasterize
    v = view_inputs(gaussians, camera, cam_idx, step, cfg, tap, abs_tap,
                    render_n, cam_delta)
    pre = R.prepare(v.means, v.quats, v.scales, v.op, v.colors, v.camera,
                    rcfg, v.normals, v.tap)
    radius = pre.proj.radius
    n_gauss = mesh.shape["gauss"]
    if n_gauss > 1:
        pre = _depth_slice(pre, mesh)
    grid = TileGrid(camera.width, camera.height, rcfg.tile_size)
    _, T_loc, tile_lo = tile_block(grid.num_tiles, mesh.shape["tile"],
                                   mesh.coords["tile"])
    r = R.render_tiles(pre, v.camera, rcfg, tile_lo=tile_lo,
                       num_tiles_local=T_loc, absgrad_tap=v.absgrad_tap)
    dev = radius.device
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    pairs_used = i0 if r.pairs_used is None else r.pairs_used
    local = torch.cat([r.out, r.alpha[..., None]], -1)
    if n_gauss > 1:
        # merge depth slices front to back: slice g's tile block attenuated
        # by the product of the nearer slices' transmittances
        g_all = comm.all_gather(mesh, local, "gauss")      # (G, T, P, C+1)
        outs = g_all[..., :-1]
        alphas = torch.clamp_max(g_all[..., -1], 1.0 - 1e-7)
        logt = torch.log1p(-alphas)                          # (G, T, P)
        t_excl = torch.exp(torch.cumsum(logt, dim=0) - logt)
        out = torch.sum(t_excl[..., None] * outs, dim=0)
        alpha = 1.0 - torch.exp(torch.sum(logt, dim=0))
        local = torch.cat([out, alpha[..., None]], dim=-1)
    # the full image over the tile axis (gradients flow back as blocks);
    # expected depth AFTER the depth-slice merge: the slice identity holds
    # for the raw accumulated channels only
    full = comm.all_gather(mesh, local, "tile", tiled=True)[:grid.num_tiles]
    out = R.RenderOutputs(
        **R.image_outputs(full[..., :-1], full[..., -1], grid,
                          device_vector(mc.background, dev)),
        mean2d=torch.zeros((1, 2), device=dev), radius=radius,
        overflow=r.bins.overflow, truncated=i0,
        trunc_by_win=torch.zeros((5,), dtype=torch.int32, device=dev),
        pairs_used=pairs_used)
    # the FULL loss stack, as the single-device step's (train/trainer.py)
    total, (_, laux) = loss_terms(out, v.normals, gaussians, v.camera, data,
                                  cam_idx, step, cfg, v.alive,
                                  render_n=render_n)
    n_shards = mesh.size_of(SHARD_AXES)
    return total / n_shards, (radius, laux["psnr"], r.bins.overflow,
                              r.bins.trunc_by_win, pairs_used)


# --------------------------------------------------------------- ZeRO-1 ----

def _slots(mesh: Mesh, capacity: int) -> slice:
    """This rank's slot slice of the capacity under ZeRO-1."""
    n = mesh.shape["data"]
    if capacity % n:
        raise ValueError("ZeRO-1 needs capacity divisible by the data axis")
    local = capacity // n
    me = mesh.coords["data"]
    return slice(me * local, (me + 1) * local)


def _pack(trees: list, n: int) -> tuple[torch.Tensor, list]:
    """Tensors with a leading capacity axis -> one (n * local * W) buffer
    laid out (n, local, W): block r holds every tensor's slots of rank r."""
    cols = [t.reshape(n, t.shape[0] // n, -1) for t in trees]
    return torch.cat(cols, dim=-1).reshape(-1), [c.shape[-1] for c in cols]


def _unpack(buf: torch.Tensor, widths: list, shapes: list) -> list:
    """_pack's inverse for a buffer of rows (slots) of sum(widths) values:
    each tensor's columns, reshaped to its shape."""
    rows = buf.reshape(-1, sum(widths))
    out, off = [], 0
    for w, shape in zip(widths, shapes):
        out.append(rows[:, off:off + w].reshape(shape).contiguous())
        off += w
    return out


def shard_opt(mesh: Mesh, opt: AdamState) -> AdamState:
    """The whole Adam state -> this rank's ZeRO-1 slice (moments and
    accumulators cut along the slots; the per-group counters replicated)."""
    sl = _slots(mesh, next(iter(opt.m.values())).shape[0])
    cut = lambda tree: {k: v[sl].clone() for k, v in tree.items()}  # noqa: E731
    return AdamState(m=cut(opt.m), v=cut(opt.v), acc=cut(opt.acc),
                     counts=dict(opt.counts))


def gather_opt(mesh: Mesh, opt: AdamState) -> AdamState:
    """This rank's ZeRO-1 slice -> the whole Adam state, gathered over
    `data` in one call (every rank of the mesh calls it)."""
    n = mesh.shape["data"]
    keys = list(opt.m)
    trees = [opt.m[k] for k in keys] + [opt.v[k] for k in keys] + \
        [opt.acc[k] for k in keys]
    buf, widths = _pack(trees, 1)
    full = comm.all_gather(mesh, buf, "data", tiled=True)
    parts = _unpack(full, widths,
                    [(n * t.shape[0],) + t.shape[1:] for t in trees])
    K = len(keys)
    return AdamState(m=dict(zip(keys, parts[:K])),
                     v=dict(zip(keys, parts[K:2 * K])),
                     acc=dict(zip(keys, parts[2 * K:])),
                     counts=dict(opt.counts))


# ----------------------------------------------------------------- step ----

def _build_sharded_step(cfg: ExperimentConfig, camera: Camera,
                        data: TrainData, mesh: Mesh, adam_groups=None,
                        shard_optimizer: bool = False, render_n=None):
    """One data x tile x gauss training step on this rank.

    step_fn(gaussians, opt, cam_state, stats, step, cam_indices) ->
    (gaussians, opt, cam_state, stats, metrics); cam_indices (n_data,)
    ints, one camera per data index. With shard_optimizer (ZeRO-1) `opt` is
    this rank's slot slice (shard_opt / gather_opt) and stays so; the
    capacity must divide by the data axis."""
    groups = adam_groups or DEFAULT_GROUPS
    n_data = mesh.shape["data"]
    use_cam_opt = cfg.train.camera_opt
    # both kernel backends write per-tile |d mean2d| into table cols 6-7;
    # the tap's gradient is then gsplat's absgrad statistic. The "jax"
    # backend has no such tap and keeps the signed screen gradient.
    use_absgrad = cfg.model.rasterize.backend in ("pallas", "flat")

    def step_fn(gaussians, opt, cam_state, stats, step, cam_indices):
        cam_idx = int(cam_indices[mesh.coords["data"]])
        cam_deltas, cam_opt = cam_state
        if cfg.model.binary_opacities:
            # logit-space surgery, identical on every rank (the replicated
            # logits and the host step decide it)
            adc = cfg.train.adc
            gaussians = gaussians.replace(
                logit_opacities=binary_opacity_surgery(
                    gaussians.logit_opacities, step,
                    threshold=cfg.model.binary_opacity_threshold,
                    warmup=adc.warmup,
                    skip=adc.reset_alpha_every * adc.refine_every,
                    margin=cfg.model.binary_opacity_margin))
        old = gaussians.params()
        params = {k: v.detach().requires_grad_(True) for k, v in old.items()}
        deltas = cam_deltas.detach().requires_grad_(use_cam_opt)
        cap = gaussians.capacity
        dev = gaussians.device
        tap = torch.zeros((cap, 2), device=dev, requires_grad=not use_absgrad)
        abs_tap = torch.zeros((cap, 2), device=dev, requires_grad=use_absgrad)
        loss, (radius, psnr, overflow, trunc_by_win, pairs_used) = (
            _sharded_losses(
                gaussians.replace(**params), camera, data, cam_idx, step, cfg,
                tap, mesh,
                cam_delta=pick(deltas, cam_idx) if use_cam_opt else None,
                render_n=render_n, abs_tap=abs_tap))
        leaves = list(params.values()) + [abs_tap if use_absgrad else tap]
        if use_cam_opt:
            leaves.append(deltas)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        K = len(params)
        keys = list(params)
        param_grads, tap_grad = grads[:K], grads[K]

        # non-finite guard: each rank votes on its LOCAL loss and gradients;
        # the votes are summed with the gradients below, so one poisoned
        # rank skips the update everywhere (the reference's pmin)
        ok_local = torch.isfinite(loss.detach())
        for g in grads[:K] + grads[K + 1:]:
            ok_local = ok_local & torch.all(torch.isfinite(g))
        scalars = torch.stack([loss.detach(), psnr.detach(),
                               (~ok_local).to(torch.float32)])
        # one SUM over every rank: parameter gradients (unless ZeRO-1
        # reduce-scatters them), the tap, the pose deltas, the scalars
        tail = [tap_grad.reshape(-1)] + [g.reshape(-1) for g in grads[K + 1:]]
        head = [] if shard_optimizer else [g.reshape(-1) for g in param_grads]
        total = comm.psum(mesh, torch.cat(head + tail + [scalars]), AXES)
        sizes = [t.numel() for t in head + tail]
        parts = list(torch.split(total[:-3], sizes))
        loss_sum, psnr_sum, votes = total[-3], total[-2], total[-1]
        ok = votes == 0
        if not shard_optimizer:
            param_grads = [p.reshape(g.shape) / n_data
                           for p, g in zip(parts[:K], param_grads)]
            parts = parts[K:]
        tap_grad = parts[0].reshape(tap_grad.shape) / n_data
        tap_grad = torch.where(ok, tap_grad, torch.zeros_like(tap_grad))

        def keep(new: dict, old: dict) -> dict:
            return {k: torch.where(ok, new[k], old[k]) for k in old}

        if use_cam_opt:
            # each data index contributes its own camera's row: the sum over
            # every rank merges them (the shard members' shares add up)
            delta_grads = parts[1].reshape(cam_deltas.shape)
            cam_p, cam_opt2 = adam_step(
                {"cam_delta": cam_deltas}, {"cam_delta": delta_grads},
                cam_opt, step, torch.ones(cam_deltas.shape[0],
                                          dtype=torch.bool, device=dev),
                groups={"cam_delta": camera_group(cfg)})
            cam_deltas = torch.where(ok, cam_p["cam_delta"], cam_deltas)
            cam_opt = _keep_adam(ok, cam_opt2, cam_opt)

        if shard_optimizer:
            # ZeRO-1: sum over the shard axes, reduce-scatter over `data`,
            # Adam on this rank's slot slice, all_gather the params back
            sl = _slots(mesh, cap)
            buf, widths = _pack(param_grads, n_data)
            buf = comm.psum(mesh, buf, SHARD_AXES)
            buf = comm.psum_scatter(mesh, buf.reshape(n_data, -1), "data")
            local_grads = _unpack(buf, widths,
                                  [(sl.stop - sl.start,) + g.shape[1:]
                                   for g in param_grads])
            local_params = {k: v[sl] for k, v in old.items()}
            new_local, opt2 = adam_step(
                local_params,
                {k: g / n_data for k, g in zip(keys, local_grads)}, opt,
                step, gaussians.alive[sl], groups=groups)
            new_local = keep(new_local, local_params)
            opt2 = _keep_adam(ok, opt2, opt)
            buf, widths = _pack([new_local[k] for k in keys], 1)
            full = comm.all_gather(mesh, buf, "data", tiled=True)
            new_p = dict(zip(keys, _unpack(full, widths,
                                           [old[k].shape for k in keys])))
        else:
            new_p, opt2 = adam_step(old, dict(zip(keys, param_grads)), opt,
                                    step, gaussians.alive, groups=groups)
            new_p = keep(new_p, old)
            opt2 = _keep_adam(ok, opt2, opt)
        g2 = gaussians.replace(**new_p)

        # the radius is per camera: accumulate its max over the batch; the
        # overflow sums over cameras, then its largest shard counts (the
        # auto tile-capacity policy); the window and budget telemetry take
        # the worst view and shard
        ovf = comm.psum(mesh, overflow.reshape(1).to(torch.int64), "data")
        maxed = comm.pmax(mesh, torch.cat([
            radius.detach().double(), trunc_by_win.double(),
            pairs_used.reshape(1).double(), ovf.double()]), AXES)
        n_r = radius.shape[0]
        radius = maxed[:n_r].to(radius.dtype)
        trunc_by_win = maxed[n_r:n_r + 5].to(torch.int32)
        pairs_used, overflow = maxed[n_r + 5:].to(torch.int32)
        if n_r < cap:   # rendered prefix -> pad
            radius = torch.cat([radius, torch.zeros(cap - n_r, device=dev)])
        st = accumulate_stats(stats, tap_grad, radius, camera.width,
                              camera.height)
        # skipped steps must not dilute the densification average
        stats2 = RefineStats(**{k: torch.where(ok, v, getattr(stats, k))
                                for k, v in st.fields().items()})
        metrics = {
            # each rank's loss is the true loss / (n_tile * n_gauss): the sum
            # over every rank over n_data is the mean over cameras
            "loss": loss_sum / n_data,
            "psnr": psnr_sum / mesh.size,
            "overflow": overflow, "trunc_by_win": trunc_by_win,
            "pairs_used": pairs_used,
            "nonfinite": (~ok).to(torch.int32),
        }
        return g2, opt2, (cam_deltas, cam_opt), stats2, metrics

    return step_fn


def make_sharded_train_step(cfg: ExperimentConfig, camera: Camera,
                            data: TrainData, mesh: Mesh, adam_groups=None,
                            shard_optimizer: bool = False,
                            tile_capacity: Optional[int] = None,
                            cover_tiles: Optional[int] = None):
    """The step of _build_sharded_step with the trainer's adaptive
    rasterizer overrides applied (train/trainer.patched_cfg)."""
    return _build_sharded_step(patched_cfg(cfg, tile_capacity, cover_tiles),
                               camera, data, mesh, adam_groups,
                               shard_optimizer)


def make_sharded_train_chunk(cfg: ExperimentConfig, camera: Camera,
                             data: TrainData, mesh: Mesh, adam_groups=None,
                             shard_optimizer: bool = False,
                             tile_capacity: Optional[int] = None,
                             cover_tiles: Optional[int] = None,
                             render_n: Optional[int] = None):
    """`n` sharded steps in a row, the counterpart of the JAX chunk's
    lax.scan: chunk_fn(gaussians, opt, cam_state, stats, step0, cam_indices
    (n, n_data)) -> (gaussians, opt, cam_state, stats, metrics), each
    metric stacked over the n steps."""
    step_fn = _build_sharded_step(patched_cfg(cfg, tile_capacity, cover_tiles),
                                  camera, data, mesh, adam_groups,
                                  shard_optimizer, render_n=render_n)

    def chunk_fn(gaussians, opt, cam_state, stats, step0, cam_indices):
        rows = []
        for i, cams in enumerate(cam_indices):
            gaussians, opt, cam_state, stats, m = step_fn(
                gaussians, opt, cam_state, stats, int(step0) + i, cams)
            rows.append(m)
        metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return gaussians, opt, cam_state, stats, metrics

    return chunk_fn
