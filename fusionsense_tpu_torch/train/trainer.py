"""The training loop: step body, per-view bin cache and host policies.

Counterpart of fusionsense_tpu/train/trainer.py, for all three rasterizer
backends. JAX fuses `scan_chunk` steps into one lax.scan; here a chunk is a
Python loop over the same step body. The flat backend's bin cache is
chunk-local exactly as the scan carry is (every view rebins on its first
visit of a chunk); the dense backends bin every step and ignore
bin_refresh_steps, as the JAX trainer does. The non-finite guard stays on
the device (torch.where on a 0-d flag), so a step makes no host sync; the
host reads metrics only at log boundaries.

Between chunks the host runs the refine boundary: the ADC refine when due
(seeded from the step as the JAX trainer seeds it), the extra callbacks
(touch anchoring, pruning), and a recompact whenever the alive set can have
changed; then the periodic checkpoint and, at log boundaries, the capacity,
render-prefix, K / pair-budget and cover-window policies. Camera
optimisation (per-view SE3 deltas under an accumulating Adam) and the SDF
loss are options of the step.

With `image_log_dir` set, every log boundary also writes a GT | rgb | depth
| normal strip of the step's view as a PNG (eval.make_render_fn,
data/image_io.py).

run_fused / sync_policies run refine intervals back to back as the JAX
trainer's fused path does (FusedIntervals); on the card each step is a
replay of a CUDA graph of the eager step (train/graphs.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import NamedTuple, Optional

import torch

from fusionsense_tpu_torch.config import ExperimentConfig
from fusionsense_tpu_torch.core.cameras import Camera, pick
from fusionsense_tpu_torch.core.transforms import apply_se3_delta
from fusionsense_tpu_torch.device import check_on, device_vector, resolve_device
from fusionsense_tpu_torch.gaussians.adc import (
    RefineStats, accumulate_stats, init_stats, refine, split_noise,
)
from fusionsense_tpu_torch.gaussians.resize import (
    compact_train_state, pick_capacity, render_bucket, resize_train_state,
)
from fusionsense_tpu_torch.gaussians.store import (
    GaussianState, activated, binary_opacity_surgery, surgery_due,
)
from fusionsense_tpu_torch.render import rasterize as R
from fusionsense_tpu_torch.render.binning import FlatBins
from fusionsense_tpu_torch.render.project import project_gaussians
from fusionsense_tpu_torch.train import losses as L
from fusionsense_tpu_torch.train.optim import (
    DEFAULT_GROUPS, AdamState, GroupSpec, adam_step, group_lr, init_adam,
)
from fusionsense_tpu_torch.train.sdf_loss import (
    sample_points_in_gaussians, sdf_loss,
)
from fusionsense_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainData:
    """All training views, stacked on one device. Optional fields may be None."""

    images: torch.Tensor                          # (V, H, W, 3)
    sensor_depths: Optional[torch.Tensor] = None  # (V, H, W)
    mono_depths: Optional[torch.Tensor] = None    # (V, H, W)
    normals: Optional[torch.Tensor] = None        # (V, H, W, 3) world-space
    masks: Optional[torch.Tensor] = None          # (V, H, W) {0,1}


def check_slice(cfg: ExperimentConfig) -> None:
    """Raise on options whose code is not in this port yet."""
    R.check_slice(cfg.model.rasterize)


def sh_active_band(sh_degree: int, step: int, interval: int) -> int:
    """The highest SH band in use at `step`: one more every `interval`."""
    return min(step // interval, sh_degree)


def sh_band_mask(sh_degree: int, step: Optional[int], interval: int,
                 device, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K,) multiplier activating one SH band per `interval` steps; `active`
    (0-d float32 on the device) replaces the band the host step gives."""
    k = (sh_degree + 1) ** 2
    bands = torch.floor(torch.sqrt(torch.arange(k, dtype=torch.float32,
                                                device=device)))
    if active is None:
        active = float(sh_active_band(sh_degree, step, interval))
    return (bands <= active).to(torch.float32)


def camera_group(cfg: ExperimentConfig) -> GroupSpec:
    """The pose deltas' Adam group: nerfstudio's camera_opt group."""
    return GroupSpec(cfg.train.camera_opt_lr,
                     every_k=cfg.train.camera_opt_every_k, eps=1e-8)


@dataclasses.dataclass
class StepInputs:
    """What the step reads of its host step number, as device values, so
    that a CUDA graph of the step can be replayed at any step: each Adam
    group's learning rate and accumulation gate (the pose deltas' group
    "cam_delta" included), the active SH band, whether the binary-opacity
    surgery applies, and the generator of the SDF draw (None when the SDF
    loss is off), which the caller seeds with the step before the step
    runs."""

    lr: dict                     # group -> 0-d float32
    gate: dict                   # group -> 0-d bool
    sh_active: torch.Tensor      # 0-d float32
    surgery: torch.Tensor        # 0-d bool
    generator: Optional[torch.Generator] = None


class StepSchedule:
    """The host side of StepInputs: one float32 row per step, with each
    group's learning rate (as group_lr computes it) and gate, the SH band
    and the surgery flag, for a table the device indexes by a step
    counter."""

    def __init__(self, cfg: ExperimentConfig, adam_groups=None):
        self.cfg = cfg
        self.groups = dict(adam_groups or DEFAULT_GROUPS)
        if cfg.train.camera_opt:
            self.groups["cam_delta"] = camera_group(cfg)

    @property
    def columns(self) -> int:
        return 2 * len(self.groups) + 2

    def rows(self, steps) -> torch.Tensor:
        """(len(steps), columns) float32 on the CPU."""
        mc, adc = self.cfg.model, self.cfg.train.adc
        out = []
        for s in steps:
            out.append(
                [group_lr(g, s) for g in self.groups.values()]
                + [float(g.every_k <= 1 or (s + 1) % g.every_k == 0)
                   for g in self.groups.values()]
                + [float(sh_active_band(mc.sh_degree, s,
                                        mc.sh_degree_interval)),
                   float(mc.binary_opacities and surgery_due(
                       s, warmup=adc.warmup,
                       skip=adc.reset_alpha_every * adc.refine_every,
                       margin=mc.binary_opacity_margin))])
        return torch.tensor(out, dtype=torch.float32)

    def inputs(self, row: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> StepInputs:
        """StepInputs read from a (columns,) row on the device."""
        G = len(self.groups)
        return StepInputs(
            lr={k: row[i] for i, k in enumerate(self.groups)},
            gate={k: row[G + i] > 0.5 for i, k in enumerate(self.groups)},
            sh_active=row[2 * G], surgery=row[2 * G + 1] > 0.5,
            generator=generator)


class ViewInputs(NamedTuple):
    """One camera's rendering inputs: the activated parameters of the
    rendered alive-first prefix, the SH bands above the active one zeroed."""

    means: torch.Tensor
    quats: torch.Tensor
    scales: torch.Tensor
    op: torch.Tensor
    colors: torch.Tensor
    alive: torch.Tensor
    tap: torch.Tensor
    absgrad_tap: Optional[torch.Tensor]
    camera: Camera               # the view, its pose delta applied
    normals: torch.Tensor        # (n, 3) flat normals facing the view


def view_inputs(gaussians: GaussianState, camera: Camera, cam_idx, step,
                cfg: ExperimentConfig, tap: torch.Tensor,
                absgrad_tap: Optional[torch.Tensor] = None,
                render_n: Optional[int] = None,
                cam_delta: Optional[torch.Tensor] = None,
                inputs: Optional[StepInputs] = None) -> ViewInputs:
    """What the single-device and the sharded step render of view cam_idx:
    render_n bounds the alive-first prefix, cam_delta (6,) is the view's
    SE3 pose correction (camera optimisation), applied to its viewmat."""
    mc = cfg.model
    means, quats, scales, op, colors = activated(gaussians)
    colors = colors * sh_band_mask(
        mc.sh_degree, step, mc.sh_degree_interval, colors.device,
        active=None if inputs is None else inputs.sh_active)[None, :, None]
    alive = gaussians.alive
    if render_n is not None and render_n < gaussians.capacity:
        means, quats, scales, op, colors = (
            means[:render_n], quats[:render_n], scales[:render_n],
            op[:render_n], colors[:render_n])
        alive = alive[:render_n]
        tap = tap[:render_n]
        if absgrad_tap is not None:
            absgrad_tap = absgrad_tap[:render_n]
    cam_i = camera.index(cam_idx)
    if cam_delta is not None:
        cam_i = cam_i.replace(viewmat=apply_se3_delta(cam_i.viewmat, cam_delta))
    return ViewInputs(means, quats, scales, op, colors, alive, tap,
                      absgrad_tap, cam_i,
                      R.gaussian_flat_normals(quats, scales, means,
                                              cam_i.origin))


def compute_losses(gaussians: GaussianState, camera: Camera, data: TrainData,
                   cam_idx: int, step: Optional[int], cfg: ExperimentConfig,
                   tap: torch.Tensor, absgrad_tap: Optional[torch.Tensor] = None,
                   render_n: Optional[int] = None, bins=None,
                   cam_delta: Optional[torch.Tensor] = None,
                   inputs: Optional[StepInputs] = None):
    """Forward + composite DN-Splatter loss for one camera (view_inputs);
    `inputs` replaces what the host step gives (StepInputs; `step` None
    then)."""
    mc = cfg.model
    v = view_inputs(gaussians, camera, cam_idx, step, cfg, tap, absgrad_tap,
                    render_n, cam_delta, inputs)
    out = R.rasterize(
        v.means, v.quats, v.scales, v.op, v.colors, v.camera, mc.rasterize,
        normals=v.normals,
        background=device_vector(mc.background, v.means.device),
        mean2d_tap=v.tap, absgrad_tap=v.absgrad_tap, bins=bins,
        device=v.means.device)
    with span("fs.losses"):
        return loss_terms(out, v.normals, gaussians, v.camera, data, cam_idx,
                          step, cfg, v.alive, render_n=render_n,
                          generator=(None if inputs is None
                                     else inputs.generator))


def loss_terms(out, normals_g, gaussians, cam_i, data, cam_idx, step, cfg,
               alive_r, render_n=None, generator=None):
    """DN-Splatter loss stack on rendered outputs -> (total, (parts, aux)).
    The SDF draw uses `generator` when given (seeded with the step by the
    caller), else a generator seeded with `step`."""
    lc = cfg.loss
    image_gt = pick(data.images, cam_idx)
    mask = (pick(data.masks, cam_idx)[..., None] if data.masks is not None
            else None)

    total = L.rgb_loss(out.rgb, image_gt, mask, lc.ssim_lambda)
    parts = {"rgb": total}
    image_floor = torch.clamp_min(image_gt, 10.0 / 255.0)

    def depth_term(gt_depth):
        valid = (gt_depth > lc.depth_tolerance).to(torch.float32)
        if mask is not None:
            valid = valid * mask[..., 0]
        if lc.depth_loss == "EdgeAwareLogL1":
            return L.depth_edge_aware_logl1(out.depth, gt_depth, image_floor,
                                            valid)
        return L.DEPTH_LOSSES[lc.depth_loss](out.depth, gt_depth, valid)

    if data.sensor_depths is not None and lc.sensor_depth_lambda > 0:
        d = depth_term(pick(data.sensor_depths, cam_idx))
        parts["sensor_depth"] = d
        total = total + lc.sensor_depth_lambda * d
    if data.mono_depths is not None and lc.mono_depth_lambda > 0:
        d = depth_term(pick(data.mono_depths, cam_idx))
        parts["mono_depth"] = d
        total = total + lc.mono_depth_lambda * d
    if lc.smooth_lambda > 0:
        sm = (L.edge_aware_tv(out.depth, image_floor)
              if lc.use_depth_smooth_edge_aware else L.tv_loss(out.depth))
        parts["smooth"] = sm
        total = total + lc.smooth_lambda * sm
    if lc.normal_lambda > 0:
        if data.normals is not None and lc.normal_supervision == "mono":
            gt_n = pick(data.normals, cam_idx)
        else:
            n_cam = L.normals_from_depth(out.depth.detach(), cam_i)
            gt_n = n_cam @ cam_i.camtoworld[:3, :3].T
        m0 = None if mask is None else mask[..., 0]
        nl = L.normal_l1(out.normal, gt_n, m0)
        if lc.use_normal_tv:
            nl = nl + L.tv_loss(out.normal)
        if lc.use_normal_cosine:
            nl = nl + L.normal_cosine(out.normal, gt_n, m0)
        parts["normal"] = nl
        total = total + lc.normal_lambda * nl
    if lc.flatness_lambda > 0:
        fl = L.flatness_loss(gaussians.log_scales, gaussians.alive)
        parts["flatness"] = fl
        total = total + lc.flatness_lambda * fl
    if lc.sparse_lambda > 0:
        sp = L.opacity_entropy_loss(gaussians.logit_opacities, gaussians.alive)
        parts["sparse"] = sp
        total = total + lc.sparse_lambda * sp
    if lc.touch_normal_lambda > 0:
        n_gt, frz = gaussians.normals, gaussians.frozen
        if render_n is not None and render_n < gaussians.capacity:
            n_gt, frz = n_gt[:render_n], frz[:render_n]
        tn = L.touch_normal_loss(normals_g, n_gt, frz)
        parts["touch_normal"] = tn
        total = total + lc.touch_normal_lambda * tn
    if lc.sdf_lambda > 0:
        s_means, s_quats, s_scales, s_op, _ = activated(gaussians)
        if render_n is not None and render_n < gaussians.capacity:
            s_means, s_quats, s_scales, s_op = (
                s_means[:render_n], s_quats[:render_n], s_scales[:render_n],
                s_op[:render_n])
        # the samples are seeded from the step, as the JAX loss seeds its key
        gen = (generator if generator is not None else
               torch.Generator(device=out.depth.device).manual_seed(step))
        pts, _ = sample_points_in_gaussians(gen, s_means, s_quats, s_scales,
                                            alive_r, lc.sdf_samples)
        sd = sdf_loss(pts, s_means, s_quats, s_scales, s_op, alive_r,
                      out.depth, cam_i)
        parts["sdf"] = sd
        total = total + lc.sdf_lambda * sd

    aux = {
        "radius": out.radius,
        "psnr": -10.0 * torch.log10(torch.mean((out.rgb - image_gt) ** 2)
                                    + 1e-10),
        "overflow": out.overflow,
        "truncated": out.truncated,
        "trunc_by_win": out.trunc_by_win,
        "pairs_used": out.pairs_used,
    }
    return total, (parts, aux)


def patched_cfg(cfg: ExperimentConfig, tile_capacity: Optional[int] = None,
                cover_tiles: Optional[int] = None) -> ExperimentConfig:
    """Apply the trainer's adaptive rasterizer overrides to the config."""
    rc = cfg.model.rasterize
    if tile_capacity is not None and tile_capacity != rc.tile_capacity:
        rc = dataclasses.replace(rc, tile_capacity=tile_capacity)
    if cover_tiles is not None and cover_tiles != rc.max_tiles_per_gaussian:
        rc = dataclasses.replace(rc, max_tiles_per_gaussian=cover_tiles)
    if rc is not cfg.model.rasterize:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, rasterize=rc))
    return cfg


class BinCache:
    """Per-view FlatBins and their ages in steps, local to one chunk: ages
    start at the refresh threshold, so every view rebins on its first visit
    (host resizes/compactions between chunks can never corrupt it)."""

    def __init__(self, num_views: int, refresh: int):
        self.bins = [None] * num_views
        self.age = [refresh] * num_views
        self.refresh = refresh

    def due(self, v: int) -> bool:
        """Tick every age for a visit of view v; True when v rebins now."""
        need = self.age[v] >= self.refresh
        self.age = [a + 1 for a in self.age]
        if need:
            self.age[v] = 1
        return need

    def lookup(self, v: int, make):
        if self.due(v):
            self.bins[v] = make()
        return self.bins[v]


def bin_view(cfg: ExperimentConfig, camera: Camera, gaussians: GaussianState,
             v: int, render_n: Optional[int],
             cam_delta: Optional[torch.Tensor] = None):
    """Project view v with the current params (and its current pose delta)
    and build its flat layout."""
    rc = cfg.model.rasterize
    N = render_n if render_n is not None else cfg.model.capacity
    with torch.no_grad():
        means, quats, scales, op, _ = activated(gaussians)
        if render_n is not None and render_n < gaussians.capacity:
            means, quats, scales, op = (means[:render_n], quats[:render_n],
                                        scales[:render_n], op[:render_n])
        cam_v = camera.index(v)
        if cam_delta is not None:
            cam_v = cam_v.replace(viewmat=apply_se3_delta(cam_v.viewmat,
                                                          cam_delta))
        with span("fs.project"):
            proj = project_gaussians(means, quats, scales, op, cam_v,
                                     near=rc.near, far=rc.far, eps2d=rc.eps2d,
                                     antialiased=rc.antialiased,
                                     radius_clip=rc.radius_clip)
        return R.flat_layout(proj, cam_v, rc, n=N)


def _keep_adam(ok: torch.Tensor, new: AdamState, old: AdamState) -> AdamState:
    """new where the step is finite, else old (every field)."""
    pick = lambda n, o: {k: torch.where(ok, n[k], o[k]) for k in o}  # noqa: E731
    return AdamState(m=pick(new.m, old.m), v=pick(new.v, old.v),
                     acc=pick(new.acc, old.acc),
                     counts=pick(new.counts, old.counts))


def train_step(gaussians: GaussianState, opt: AdamState, cam_state,
               stats: RefineStats, step: Optional[int], cam_idx: int, *,
               cfg: ExperimentConfig, camera: Camera, data: TrainData,
               adam_groups=None, render_n: Optional[int] = None,
               cache: Optional[BinCache] = None,
               inputs: Optional[StepInputs] = None):
    """One training step -> (gaussians, opt, cam_state, stats, metrics).
    `cfg` must carry the adaptive overrides (patched_cfg); `cache` is the
    chunk's BinCache (flat backend only), or None to bin every step;
    cam_state is (deltas (V, 6), AdamState), updated when
    cfg.train.camera_opt. With `inputs` (StepInputs) the step reads its
    step-dependent values from the device instead of `step`, which is then
    None: that is the step a CUDA graph captures (train/graphs.py)."""
    with span("fs.step", step):
        groups = adam_groups or DEFAULT_GROUPS
        use_cam_opt = cfg.train.camera_opt
        cam_deltas, cam_opt = cam_state
        dev_kw = ({} if inputs is None
                  else dict(lr=inputs.lr, gate=inputs.gate))
        if cfg.model.binary_opacities:
            adc = cfg.train.adc
            gaussians = gaussians.replace(
                logit_opacities=binary_opacity_surgery(
                    gaussians.logit_opacities, step,
                    threshold=cfg.model.binary_opacity_threshold,
                    warmup=adc.warmup,
                    skip=adc.reset_alpha_every * adc.refine_every,
                    margin=cfg.model.binary_opacity_margin,
                    due=None if inputs is None else inputs.surgery))
        fb = None
        if cache is not None:
            delta_v = pick(cam_deltas, cam_idx) if use_cam_opt else None
            fb = cache.lookup(cam_idx, lambda: bin_view(
                cfg, camera, gaussians, cam_idx, render_n, cam_delta=delta_v))

        old = gaussians.params()
        params = {k: v.detach().requires_grad_(True) for k, v in old.items()}
        deltas = cam_deltas.detach().requires_grad_(use_cam_opt)
        cap = gaussians.capacity
        dev = gaussians.device
        # the kernel backends (pallas, flat) surface gsplat's absgrad through
        # table cols 6-7, and densification reads it; the "jax" backend has
        # no such tap and falls back to the signed screen-position gradient.
        # Only the tap that is read is differentiated.
        use_absgrad = cfg.model.rasterize.backend in ("pallas", "flat")
        tap = torch.zeros((cap, 2), device=dev, requires_grad=not use_absgrad)
        abs_tap = torch.zeros((cap, 2), device=dev, requires_grad=use_absgrad)
        with span("fs.forward"):
            loss, (_, aux) = compute_losses(
                gaussians.replace(**params), camera, data, cam_idx, step, cfg,
                tap, absgrad_tap=abs_tap, render_n=render_n, bins=fb,
                cam_delta=pick(deltas, cam_idx) if use_cam_opt else None,
                inputs=inputs)
        leaves = list(params.values()) + [abs_tap if use_absgrad else tap]
        if use_cam_opt:
            leaves.append(deltas)
        with span("fs.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, leaves)]
        n = len(params)
        param_grads = dict(zip(params.keys(), grads[:n]))
        tap_grad = grads[n]

        with span("fs.update"):
            # non-finite guard: skip the whole update on a NaN/inf loss or
            # gradient (the pose deltas' too), decided on the device (no
            # host sync)
            ok = torch.isfinite(loss.detach())
            for g in grads[:n] + grads[n + 1:]:
                ok = ok & torch.all(torch.isfinite(g))
            tap_grad = torch.where(ok, tap_grad, torch.zeros_like(tap_grad))

            new_p, opt2 = adam_step(old, param_grads, opt, step,
                                    gaussians.alive, groups=groups, **dev_kw)
            new_p = {k: torch.where(ok, new_p[k], old[k]) for k in old}
            opt2 = _keep_adam(ok, opt2, opt)
            gaussians2 = gaussians.replace(**new_p)

            if use_cam_opt:
                # accumulated, bias-corrected Adam on the (V, 6) pose deltas
                cam_p, cam_opt2 = adam_step(
                    {"cam_delta": cam_deltas}, {"cam_delta": grads[-1]},
                    cam_opt, step,
                    torch.ones(cam_deltas.shape[0], dtype=torch.bool,
                               device=dev),
                    groups={"cam_delta": camera_group(cfg)}, **dev_kw)
                cam_deltas = torch.where(ok, cam_p["cam_delta"], cam_deltas)
                cam_opt = _keep_adam(ok, cam_opt2, cam_opt)

            radius = aux["radius"].detach()
            if radius.shape[0] < cap:
                radius = torch.cat([radius, torch.zeros(cap - radius.shape[0],
                                                        device=dev)])
            st = accumulate_stats(stats, tap_grad, radius, camera.width,
                                  camera.height)
            stats2 = RefineStats(
                **{k: torch.where(ok, v, getattr(stats, k))
                   for k, v in st.fields().items()})
        metrics = {"loss": loss.detach(), "psnr": aux["psnr"].detach(),
                   "overflow": aux["overflow"], "truncated": aux["truncated"],
                   "trunc_by_win": aux["trunc_by_win"],
                   "pairs_used": aux["pairs_used"],
                   "nonfinite": (~ok).to(torch.int32)}
        return gaussians2, opt2, (cam_deltas, cam_opt), stats2, metrics


def make_fused_intervals(cfg: ExperimentConfig, camera: Camera,
                         data: TrainData, adam_groups=None,
                         render_n: Optional[int] = None,
                         tile_capacity: Optional[int] = None,
                         cover_tiles: Optional[int] = None,
                         interval: Optional[int] = None,
                         n_intervals: int = 5, scene_scale: float = 1.0,
                         pool=None):
    """The JAX trainer's make_fused_intervals: f(gaussians, opt, cam_state,
    stats, step0) -> (gaussians, opt, cam_state, stats, metrics) running
    n_intervals refine intervals (FusedIntervals; `pool` is the CUDA graph
    memory pool on the card)."""
    fused = FusedIntervals(cfg, camera, data, adam_groups=adam_groups,
                           render_n=render_n, tile_capacity=tile_capacity,
                           cover_tiles=cover_tiles, interval=interval,
                           scene_scale=scene_scale, pool=pool)
    return lambda g, o, cs, st, step0: fused(g, o, cs, st, step0, n_intervals)


def refine_due(adc, step: int) -> bool:
    """The JAX trainer's refine gate: warmup <= step < stop_split_at, on the
    refine_every grid."""
    return (step >= adc.warmup and step < adc.stop_split_at
            and (step - adc.warmup) % adc.refine_every == 0)


def refine_at(gaussians: GaussianState, opt: AdamState, stats: RefineStats,
              step: int, cfg: ExperimentConfig, scene_scale: float):
    """The ADC refine at `step`, its split normals drawn from a generator
    seeded as the JAX trainer seeds its key: seed * 1_000_003 + step, as
    uint32. Returns (gaussians, opt, stats, info)."""
    dev = gaussians.device
    seed = (cfg.train.seed * 1_000_003 + step) % (1 << 32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = split_noise(gen, cfg.train.adc.n_split_samples,
                        gaussians.capacity, dev)
    return refine(gaussians, opt, stats, noise, cfg.train.adc, step,
                  scene_scale=scene_scale)


def map_train_state(gaussians, opt, cam_state, stats, fn):
    """fn applied to every tensor of the training state (gaussians, Adam
    state, (pose deltas, their Adam state), refine stats), structure kept:
    map_train_state(*state, torch.clone) copies a trainer's state."""
    def adam(o):
        return AdamState(*({k: fn(v) for k, v in tree.items()}
                           for tree in (o.m, o.v, o.acc, o.counts)))
    return (GaussianState(**{k: fn(v) for k, v in gaussians.fields().items()}),
            adam(opt), (fn(cam_state[0]), adam(cam_state[1])),
            RefineStats(**{k: fn(v) for k, v in stats.fields().items()}))


def _state_tensors(gaussians, opt, cam_state, stats) -> list:
    out = []
    map_train_state(gaussians, opt, cam_state, stats, out.append)
    return out


class _BinSlots:
    """A fused interval's per-view FlatBins, each field stacked over the
    views in one persistent buffer: a visit that rebins (BinCache's
    decision, taken on the host) writes row v, the others read it; v is a
    (1,) index tensor on the device."""

    def __init__(self, slots: FlatBins, rebin: bool, write: bool):
        self.slots, self.rebin, self.write = slots, rebin, write

    def lookup(self, v: torch.Tensor, make):
        if not self.rebin:
            return FlatBins(*(None if x is None else pick(x, v)
                              for x in self.slots))
        fb = make()
        if self.write:
            for dst, src in zip(self.slots, fb):
                if dst is not None:
                    dst.index_copy_(0, v, src[None])
        return fb


_METRICS = {"loss": torch.float32, "psnr": torch.float32,
            "overflow": torch.int32, "pairs_used": torch.int32}


class FusedIntervals:
    """Refine intervals back to back, as the JAX trainer's
    make_fused_intervals: each interval runs `interval` steps with camera
    order (s0 + i) % V and a bin cache that starts stale, then, when the
    refine gate fires at its end, the ADC refine (seeded as
    Trainer.refine_boundary seeds it) and the alive-first compaction. No
    extra callback, checkpoint, debug grid or policy runs, and render_n is
    not re-picked. One metrics row per interval: the last step's loss,
    psnr, overflow, trunc_by_win and pairs_used, and the summed nonfinite.

    The steps run in persistent buffers with their step-dependent values
    read from the device (StepInputs and the view, tables of the interval's
    rows indexed by a step counter). On a CUDA device each step is a replay
    of a CUDA graph, one per rebin decision: two with the flat bin cache,
    one without (train/graphs.py); on the CPU the same step runs eagerly.
    The refine and compaction run eagerly between intervals; neither makes
    a host sync."""

    def __init__(self, cfg: ExperimentConfig, camera: Camera, data: TrainData,
                 *, adam_groups=None, render_n: Optional[int] = None,
                 tile_capacity: Optional[int] = None,
                 cover_tiles: Optional[int] = None,
                 interval: Optional[int] = None, scene_scale: float = 1.0,
                 pool=None):
        self.cfg = patched_cfg(cfg, tile_capacity, cover_tiles)
        self.camera, self.data = camera, data
        self.adam_groups = adam_groups
        self.render_n = render_n
        self.interval = interval or cfg.train.adc.refine_every
        self.scene_scale = scene_scale
        self.num_views = data.images.shape[0]
        self.sched = StepSchedule(cfg, adam_groups)
        dev = data.images.device
        self.buf = self.bins = None    # allocated by the first call
        self.table = torch.zeros((self.interval, self.sched.columns),
                                 device=dev)
        self.views = torch.zeros((self.interval,), dtype=torch.int64,
                                 device=dev)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.last = {k: torch.zeros((), dtype=t, device=dev)
                     for k, t in _METRICS.items()}
        self.last["trunc_by_win"] = torch.zeros((5,), dtype=torch.int32,
                                                device=dev)
        self.nonfinite = torch.zeros((), dtype=torch.int32, device=dev)
        self.generator = (torch.Generator(device=dev)
                          if cfg.loss.sdf_lambda > 0 else None)
        self.refresh = cfg.train.bin_refresh_steps
        self.graphs = None
        if dev.type == "cuda":
            from fusionsense_tpu_torch.train.graphs import StepGraphs

            self.graphs = StepGraphs(pool, self.generator)

    def _allocate(self, state) -> None:
        """The persistent buffers: a copy of the state and, with the bin
        cache, every view's bins stacked (valid values for their shapes)."""
        self.buf = map_train_state(*state, torch.clone)
        if self.refresh > 0 and self.cfg.model.rasterize.backend == "flat":
            deltas = self.buf[2][0]
            cam_opt = self.cfg.train.camera_opt
            per_view = [bin_view(self.cfg, self.camera, self.buf[0], v,
                                 self.render_n,
                                 cam_delta=deltas[v] if cam_opt else None)
                        for v in range(self.num_views)]
            self.bins = FlatBins(*(None if f[0] is None else torch.stack(f)
                                   for f in zip(*per_view)))

    def _load(self, *state) -> None:
        for dst, src in zip(_state_tensors(*self.buf), _state_tensors(*state)):
            dst.copy_(src)

    def _step(self, rebin: bool, commit: bool = True) -> None:
        """One step from the buffers, its view and step-dependent values
        read at the step counter; with commit, its results go back into the
        buffers and the counter advances."""
        row = self.table.index_select(0, self.counter)[0]
        v = self.views.index_select(0, self.counter)
        cache = (None if self.bins is None
                 else _BinSlots(self.bins, rebin, commit))
        g, o, cs, st, m = train_step(
            *self.buf, None, v, cfg=self.cfg,
            camera=self.camera, data=self.data, adam_groups=self.adam_groups,
            render_n=self.render_n, cache=cache,
            inputs=self.sched.inputs(row, self.generator))
        if commit:
            self._load(g, o, cs, st)
            for k, t in self.last.items():
                t.copy_(m[k])
            self.nonfinite.add_(m["nonfinite"])
            self.counter.add_(1)

    def __call__(self, gaussians, opt, cam_state, stats, step0: int,
                 n_intervals: int):
        """Run n_intervals intervals from step0 ->
        (gaussians, opt, cam_state, stats, metrics), the state new tensors
        and metrics one row per interval."""
        if self.buf is None:
            self._allocate((gaussians, opt, cam_state, stats))
        else:
            self._load(gaussians, opt, cam_state, stats)
        adc = self.cfg.train.adc
        rows = []
        for i in range(n_intervals):
            s0 = step0 + i * self.interval
            host = (self.sched.rows(range(s0, s0 + self.interval)),
                    torch.arange(s0, s0 + self.interval) % self.num_views)
            for dst, src in zip((self.table, self.views), host):
                if self.graphs is not None:   # no host sync: pinned, async
                    dst.copy_(src.pin_memory(), non_blocking=True)
                else:
                    dst.copy_(src)
            self.counter.zero_()
            self.nonfinite.zero_()
            # every view rebins on its first visit of the interval, so the
            # refine and compaction below never meet stale slots
            cache = (BinCache(self.num_views, self.refresh)
                     if self.bins is not None else None)
            for s in range(s0, s0 + self.interval):
                rebin = cache is not None and cache.due(s % self.num_views)
                if self.generator is not None:
                    self.generator.manual_seed(s)
                if self.graphs is None:
                    self._step(rebin)
                else:
                    self.graphs.run(rebin, functools.partial(self._step,
                                                             rebin))
            s_end = s0 + self.interval
            if refine_due(adc, s_end):
                g, o, st, _ = refine_at(self.buf[0], self.buf[1], self.buf[3],
                                        s_end, self.cfg, self.scene_scale)
                g, o, st = compact_train_state(g, o, st)
                self._load(g, o, self.buf[2], st)
            row = {k: t.clone() for k, t in self.last.items()}
            row["nonfinite"] = self.nonfinite.clone()
            rows.append(row)
        metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return (*map_train_state(*self.buf, torch.clone), metrics)


class Trainer:
    """Chunks of steps, the refine boundary between them (ADC refine,
    callbacks, recompact), periodic checkpoints, and the capacity-bucket /
    render-prefix / tile-capacity / cover-window policies at log
    boundaries, as the JAX Trainer runs them: the dense backends grow K by
    the overflow ladder, the flat backend sizes its pair budget from the
    live pair total.

    extra_callbacks are called with the trainer after every chunk (after
    the refine when one is due); a truthy return says the alive set
    changed. Set `checkpoint_dir` to save every cfg.train.steps_per_save
    steps."""

    writer = True    # this process logs and writes (one rank of a mesh)
    # the per-step counters _run_chunk sums, summed again over the chunks
    # since the last log boundary into its history record
    COUNTS = ("nonfinite_steps", "pairs_dropped", "pairs_truncated")

    def __init__(self, cfg: ExperimentConfig, camera: Camera, data: TrainData,
                 gaussians: GaussianState, scene_scale: float = 1.0,
                 extra_callbacks: Optional[list] = None,
                 adam_groups: Optional[dict] = None, device=None):
        check_slice(cfg)
        self.device = resolve_device(device)
        check_on(self.device, viewmat=camera.viewmat, images=data.images,
                 means=gaussians.means)
        self.cfg = cfg
        self.camera = camera
        self.data = data
        self.gaussians = gaussians
        self.opt = init_adam(gaussians.params())
        self.stats = init_stats(gaussians.capacity, self.device)
        self.scene_scale = scene_scale
        self.num_views = data.images.shape[0]
        self.step = 0
        self.extra_callbacks = extra_callbacks or []
        self.checkpoint_dir = None   # a path enables the periodic saves
        self.image_log_dir = None    # a path enables the debug image dumps
        self._debug_render = None
        z6 = torch.zeros((self.num_views, 6), device=self.device)
        self.cam_state = (z6, init_adam({"cam_delta": z6}))  # pose deltas
        self.max_capacity = gaussians.capacity
        self.auto_capacity = cfg.train.auto_capacity
        self._adam_groups = adam_groups
        self.render_n: Optional[int] = None
        rc = cfg.model.rasterize
        self.tile_capacity = rc.tile_capacity
        cap_tiles = rc.max_tiles_per_gaussian
        self.cover_tiles = (min(4, cap_tiles) if cfg.train.auto_cover_window
                            else cap_tiles)
        self._grid_tiles = (-(-camera.width // rc.tile_size)
                            * -(-camera.height // rc.tile_size))
        self._budget_tiles = self._grid_tiles   # the tiles a budget serves
        self._counts = None          # COUNTS since the last log boundary
        self._fused: dict = {}       # run_fused's FusedIntervals by key
        self._graph_pool = None      # one CUDA graph memory pool for them
        if self.auto_capacity:
            n0 = int(self.gaussians.num_alive)
            cap0 = pick_capacity(n0, self.gaussians.capacity,
                                 self.max_capacity,
                                 minimum=min(1024, self.max_capacity))
            if cap0 != self.gaussians.capacity:
                self.gaussians, self.opt, self.stats = resize_train_state(
                    self.gaussians, self.opt, self.stats, new_capacity=cap0)
        if cfg.train.render_prefix:
            self._recompact(int(self.gaussians.num_alive))
        self.history: list[dict] = []

    def _recompact(self, n_alive: int):
        """Re-establish the alive-first prefix and pick the render bucket
        (grow at once, shrink with hysteresis)."""
        self.gaussians, self.opt, self.stats = compact_train_state(
            self.gaussians, self.opt, self.stats)
        want = render_bucket(n_alive, self.gaussians.capacity)
        if (self.render_n is None or want > self.render_n
                or want * 1.5 <= self.render_n
                or want == self.gaussians.capacity):
            self.render_n = want
        else:
            self.render_n = min(self.render_n, self.gaussians.capacity)

    @property
    def _is_flat(self) -> bool:
        return self.cfg.model.rasterize.backend == "flat"

    def _maybe_bump_tile_capacity(self, overflow: int):
        """Dense backends: grow K by 1.5x, rounded up to 128, when the pairs
        dropped past K exceed tile_overflow_frac of the T * K slots."""
        tc = self.cfg.train
        if not tc.auto_tile_capacity or self._is_flat:
            return
        if overflow <= tc.tile_overflow_frac * self._grid_tiles * self.tile_capacity:
            return
        if self.tile_capacity >= tc.max_tile_capacity:
            return
        want = -(-int(self.tile_capacity * 1.5) // 128) * 128
        self.tile_capacity = min(want, tc.max_tile_capacity)

    def _maybe_resize_pair_budget(self, used: int):
        """Size the flat pair budget from the block-aligned live pair total:
        1.25x headroom, 64 pairs/tile granularity, shrink with hysteresis."""
        tc = self.cfg.train
        if not self._is_flat or not tc.auto_tile_capacity or used <= 0:
            return
        T = self._budget_tiles
        target = -(-used * 5 // (4 * T) // 64) * 64
        target = max(64, min(target, tc.max_tile_capacity))
        if target > self.tile_capacity or target * 2 <= self.tile_capacity:
            self.tile_capacity = target

    def _maybe_adjust_cover_window(self, trunc_by_win):
        """Smallest cover window whose truncation is negligible (grow at
        once, shrink at half the tolerance)."""
        tc = self.cfg.train
        if not tc.auto_cover_window:
            return
        cap_tiles = self.cfg.model.rasterize.max_tiles_per_gaussian
        pop = self.render_n or self.gaussians.capacity
        tol = tc.cover_trunc_frac * pop
        cur_w = max(1, int(math.isqrt(self.cover_tiles)))
        w_max = min(5, max(1, int(math.isqrt(cap_tiles))))
        want_w = w_max
        for w in range(1, w_max + 1):
            if trunc_by_win[w - 1] <= (tol if w >= cur_w else 0.5 * tol):
                want_w = w
                break
        if want_w != cur_w:
            self.cover_tiles = want_w * want_w

    def _pick_capacity(self, n_alive: int) -> int:
        return pick_capacity(n_alive, self.gaussians.capacity,
                             self.max_capacity,
                             minimum=min(1024, self.max_capacity))

    def _rebucket(self, n_alive: int):
        """At a log boundary: re-bucket the capacity (auto_capacity) and
        re-pick the render prefix."""
        if self.auto_capacity:
            cap = self._pick_capacity(n_alive)
            if cap != self.gaussians.capacity:
                self.gaussians, self.opt, self.stats = resize_train_state(
                    self.gaussians, self.opt, self.stats, new_capacity=cap)
        if self.cfg.train.render_prefix:
            self._recompact(n_alive)

    def _mutate(self):
        """The ADC refine when one is due at this step, then the extra
        callbacks -> (the refine's info or None, whether the alive set can
        have changed)."""
        cfg = self.cfg
        info = None
        changed = False
        if refine_due(cfg.train.adc, self.step):
            self.gaussians, self.opt, self.stats, info = refine_at(
                self.gaussians, self.opt, self.stats, self.step, cfg,
                self.scene_scale)
            changed = True
        for cb in self.extra_callbacks:
            changed |= bool(cb(self))
        return info, changed

    def refine_boundary(self) -> Optional[dict]:
        """The host side between chunks: the ADC refine when one is due at
        this step, then the extra callbacks, then the recompact whenever the
        alive set can have changed (slots past render_n are never
        rasterized). Returns the refine's info (device tensors) or None."""
        with span("fs.refine_boundary"):
            info, changed = self._mutate()
            if changed and self.cfg.train.render_prefix:
                self._recompact(int(self.gaussians.num_alive))
            return info

    def save(self, path):
        """Full checkpoint: model, optimiser, stats, step, camera optimiser
        and the host policy state (train/checkpoint.py)."""
        from fusionsense_tpu_torch.train.checkpoint import save_trainer_state

        save_trainer_state(self, path)

    def restore(self, path):
        """Resume mid-training from a Trainer.save checkpoint."""
        from fusionsense_tpu_torch.train.checkpoint import restore_trainer_state

        restore_trainer_state(self, path)
        if self.cfg.train.render_prefix:
            self._recompact(int(self.gaussians.num_alive))
        return self

    def run_fused(self, n_intervals: int, interval: Optional[int] = None,
                  block: bool = False):
        """Advance n_intervals refine intervals (FusedIntervals): on the
        card, replays of CUDA graphs of the step, with the refine and the
        compaction between intervals and no host sync. Preconditions the
        caller owns, as in the JAX trainer: the adaptive policies have
        settled, and self.step sits on a refine boundary (else ValueError).
        Host policy state is not updated: call sync_policies() after.

        Returns the per-interval metrics (device tensors, one row per
        interval); block=True waits for the device."""
        adc = self.cfg.train.adc
        interval = interval or adc.refine_every
        if (self.step - adc.warmup) % adc.refine_every:
            raise ValueError(
                f"run_fused at step {self.step}: not on a refine boundary")
        # JAX's _chunk_cache key; the step gates are device inputs here
        key = (self.gaussians.capacity, self.render_n, self.tile_capacity,
               self.cover_tiles, interval)
        state = (self.gaussians, self.opt, self.cam_state, self.stats)
        fn = self._fused.get(key)
        if fn is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            fn = self._fused[key] = FusedIntervals(
                self.cfg, self.camera, self.data,
                adam_groups=self._adam_groups, render_n=self.render_n,
                tile_capacity=self.tile_capacity,
                cover_tiles=self.cover_tiles, interval=interval,
                scene_scale=self.scene_scale, pool=self._graph_pool)
        (self.gaussians, self.opt, self.cam_state, self.stats,
         metrics) = fn(*state, self.step, n_intervals)
        self.step += n_intervals * interval
        if block and self.device.type == "cuda":
            torch.cuda.synchronize()
        return metrics

    def graph_stats(self) -> dict:
        """CUDA graphs captured by run_fused so far: their number, the
        seconds their captures took (warm-ups included), their replays and
        the MB their shared memory pool holds."""
        gs = [f.graphs for f in self._fused.values() if f.graphs is not None]
        out = {"graphs": sum(len(g.graphs) for g in gs),
               "capture_s": sum(g.capture_s for g in gs),
               "replays": sum(g.replays for g in gs), "pool_mb": 0.0}
        if self._graph_pool is not None:
            from fusionsense_tpu_torch.train.graphs import pool_bytes

            out["pool_mb"] = pool_bytes(self._graph_pool)[1] / 1e6
        return out

    def sync_policies(self, metrics=None):
        """One host read re-establishing the adaptive policy state after
        run_fused: re-bucket capacity, re-pick the render prefix, and tick
        the K, pair-budget and cover-window policies from `metrics` (the
        last run_fused return; its final row). Appends the JAX trainer's
        history record and returns n_alive."""
        fetch = [self.gaussians.num_alive.reshape(1)]
        if metrics is not None:
            fetch += [metrics[k][-1].reshape(1) for k in
                      ("pairs_used", "overflow", "loss", "psnr")]
            fetch += [metrics["nonfinite"].sum().reshape(1),
                      metrics["trunc_by_win"][-1].reshape(-1)]
        vals = torch.cat([x.double() for x in fetch]).tolist()
        n_alive = int(vals[0])
        self._rebucket(n_alive)
        if metrics is not None:
            pu, ovf, loss_h, psnr_h, nf = vals[1:6]
            self._maybe_bump_tile_capacity(int(ovf))
            self._maybe_resize_pair_budget(int(pu))
            self._maybe_adjust_cover_window([int(x) for x in vals[6:]])
            self.history.append({
                "step": self.step, "loss": loss_h, "psnr": psnr_h,
                "num_gaussians": n_alive, "tile_overflow": int(ovf),
                "nonfinite_steps": int(nf),
                "capacity": self.gaussians.capacity,
            })
        return n_alive

    def _run_chunk(self, n: int):
        """n steps from self.step -> (the last step's metrics, the chunk's
        sums of COUNTS: its non-finite steps, the pairs its steps dropped
        past the pair budget or K, and the pairs the cover window cut)."""
        cfg_p = patched_cfg(self.cfg, self.tile_capacity, self.cover_tiles)
        refresh = self.cfg.train.bin_refresh_steps
        cache = (BinCache(self.num_views, refresh)
                 if refresh > 0 and self._is_flat else None)
        counts = []
        for _ in range(n):
            (self.gaussians, self.opt, self.cam_state, self.stats,
             metrics) = train_step(
                self.gaussians, self.opt, self.cam_state, self.stats,
                self.step, self.step % self.num_views, cfg=cfg_p,
                camera=self.camera, data=self.data,
                adam_groups=self._adam_groups, render_n=self.render_n,
                cache=cache)
            counts += [metrics["nonfinite"], metrics["overflow"],
                       metrics["truncated"]]
            self.step += 1
        return metrics, torch.stack(counts).view(n, 3).sum(0)

    def run(self, iterations: Optional[int] = None, log=print):
        """Train to `iterations` (cfg.train.iterations by default) in chunks
        that end at refine steps, with the refine boundary, debug grids,
        checkpoints and the log-boundary policies between them. Only the
        `writer` logs and dumps debug grids (parallel.ShardedTrainer runs
        this loop on every rank)."""
        cfg = self.cfg
        total = iterations if iterations is not None else cfg.train.iterations
        adc = cfg.train.adc
        log = log if self.writer else None
        t0 = time.time()
        while self.step < total:
            n = min(cfg.train.scan_chunk, total - self.step)
            # chunks end at refine steps: the refine, compaction and
            # callbacks run between chunks, never inside the chunk-local
            # bin cache's life
            next_refine = ((self.step - adc.warmup) // adc.refine_every + 1
                           ) * adc.refine_every + adc.warmup
            if self.step < adc.warmup:
                next_refine = adc.warmup
            n = max(1, min(n, next_refine - self.step))
            metrics, counts = self._run_chunk(n)
            self._counts = (counts if self._counts is None
                            else self._counts + counts)

            self.refine_boundary()
            if (self.writer and self.image_log_dir is not None
                    and self.step % cfg.train.log_every == 0):
                self._dump_debug_grid()
            if (self.checkpoint_dir is not None
                    and self.step % cfg.train.steps_per_save == 0):
                self.save(f"{self.checkpoint_dir}/ckpt_{self.step}")

            if self.step % cfg.train.log_every == 0 or self.step >= total:
                with span("fs.log_boundary"):
                    self._log_boundary(metrics, log, t0)
        return self.history

    def _log_boundary(self, metrics: dict, log, t0: float):
        """One host read for all logged scalars (the chunk's last metrics,
        the COUNTS since the last log boundary, the population), the history
        record, and the capacity, render-prefix, K / pair-budget and
        cover-window policies."""
        k = 5 + len(self.COUNTS)
        vals = torch.stack([
            metrics["loss"].double(), metrics["psnr"].double(),
            metrics["overflow"].double(), metrics["pairs_used"].double(),
            self.gaussians.num_alive.double(), *self._counts.double(),
            *metrics["trunc_by_win"].double()]).tolist()
        loss_h, psnr_h, ovf_h, pu_h, n_alive = vals[:5]
        counts = dict(zip(self.COUNTS, (int(x) for x in vals[5:k])))
        tbw_h = [int(x) for x in vals[k:]]
        self._counts = None
        nf_h = counts["nonfinite_steps"]
        if nf_h and log:
            log(f"WARNING: skipped {nf_h} non-finite step(s) "
                f"since the last log (now at step {self.step})")
        rec = {
            "step": self.step, "loss": loss_h, "psnr": psnr_h,
            "num_gaussians": int(n_alive), "tile_overflow": int(ovf_h),
            **counts, "capacity": self.gaussians.capacity,
            "pairs_used": int(pu_h), "elapsed_s": time.time() - t0,
        }
        self._rebucket(int(n_alive))
        self._maybe_bump_tile_capacity(int(ovf_h))
        self._maybe_resize_pair_budget(int(pu_h))
        self._maybe_adjust_cover_window(tbw_h)
        self.history.append(rec)
        if log:
            log(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
                f"psnr {rec['psnr']:.2f}  n {rec['num_gaussians']}")

    def _dump_debug_grid(self):
        """GT | rgb | depth | normal strip of this step's view, written as
        image_log_dir/step_<step>.png (depth min-max normalised, normals
        mapped from [-1, 1])."""
        from pathlib import Path

        from fusionsense_tpu_torch.data.image_io import write_png
        from fusionsense_tpu_torch.eval.evaluator import make_render_fn

        if self._debug_render is None:
            self._debug_render = make_render_fn(self.cfg.model.rasterize,
                                                self.camera)
        i = self.step % self.num_views
        out = self._debug_render(self.gaussians, i)
        d = out.depth
        d = (d - d.min()) / torch.clamp_min(d.max() - d.min(), 1e-8)
        grid = torch.cat([self.data.images[i], torch.clamp(out.rgb, 0, 1),
                          torch.stack([d] * 3, -1),
                          torch.clamp(out.normal * 0.5 + 0.5, 0, 1)], dim=1)
        path = Path(self.image_log_dir)
        path.mkdir(parents=True, exist_ok=True)
        write_png(path / f"step_{self.step:06d}.png",
                  (grid * 255).cpu().numpy().astype("uint8"))
