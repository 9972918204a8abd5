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

Not ported yet (each raises): make_fused_intervals / run_fused /
sync_policies (ROADMAP N2).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from fusionsense_tpu_torch.config import ExperimentConfig
from fusionsense_tpu_torch.core.cameras import Camera
from fusionsense_tpu_torch.core.transforms import apply_se3_delta
from fusionsense_tpu_torch.device import check_on, resolve_device
from fusionsense_tpu_torch.gaussians.adc import (
    RefineStats, accumulate_stats, init_stats, refine, split_noise,
)
from fusionsense_tpu_torch.gaussians.resize import (
    compact_train_state, pick_capacity, render_bucket, resize_train_state,
)
from fusionsense_tpu_torch.gaussians.store import (
    GaussianState, activated, binary_opacity_surgery,
)
from fusionsense_tpu_torch.render import rasterize as R
from fusionsense_tpu_torch.render.binning import (
    auto_expand_budget, flat_bin_gaussians,
)
from fusionsense_tpu_torch.render.composite import TileGrid
from fusionsense_tpu_torch.render.project import project_gaussians
from fusionsense_tpu_torch.train import losses as L
from fusionsense_tpu_torch.train.optim import (
    DEFAULT_GROUPS, AdamState, GroupSpec, adam_step, init_adam,
)
from fusionsense_tpu_torch.train.sdf_loss import (
    sample_points_in_gaussians, sdf_loss,
)


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


def sh_band_mask(sh_degree: int, step: int, interval: int,
                 device) -> torch.Tensor:
    """(K,) multiplier activating one SH band per `interval` steps."""
    k = (sh_degree + 1) ** 2
    bands = torch.floor(torch.sqrt(torch.arange(k, dtype=torch.float32,
                                                device=device)))
    active = float(min(step // interval, sh_degree))
    return (bands <= active).to(torch.float32)


def compute_losses(gaussians: GaussianState, camera: Camera, data: TrainData,
                   cam_idx: int, step: int, cfg: ExperimentConfig,
                   tap: torch.Tensor, absgrad_tap: Optional[torch.Tensor] = None,
                   render_n: Optional[int] = None, bins=None,
                   cam_delta: Optional[torch.Tensor] = None):
    """Forward + composite DN-Splatter loss for one camera. render_n bounds
    the rasterized alive-first prefix; cam_delta (6,) is the view's SE3 pose
    correction (camera optimisation), applied to its viewmat."""
    mc = cfg.model
    means, quats, scales, op, colors = activated(gaussians)
    colors = colors * sh_band_mask(mc.sh_degree, step, mc.sh_degree_interval,
                                   colors.device)[None, :, None]
    alive_r = gaussians.alive
    if render_n is not None and render_n < gaussians.capacity:
        means, quats, scales, op, colors = (
            means[:render_n], quats[:render_n], scales[:render_n],
            op[:render_n], colors[:render_n])
        alive_r = alive_r[:render_n]
        tap = tap[:render_n]
        if absgrad_tap is not None:
            absgrad_tap = absgrad_tap[:render_n]
    cam_i = camera.index(cam_idx)
    if cam_delta is not None:
        cam_i = cam_i.replace(viewmat=apply_se3_delta(cam_i.viewmat, cam_delta))
    normals_g = R.gaussian_flat_normals(quats, scales, means, cam_i.origin)
    out = R.rasterize(
        means, quats, scales, op, colors, cam_i, mc.rasterize,
        normals=normals_g,
        background=torch.tensor(mc.background, dtype=torch.float32,
                                device=means.device),
        mean2d_tap=tap, absgrad_tap=absgrad_tap, bins=bins,
        device=means.device)
    return loss_terms(out, normals_g, gaussians, cam_i, data, cam_idx, step,
                      cfg, alive_r, render_n=render_n)


def loss_terms(out, normals_g, gaussians, cam_i, data, cam_idx, step, cfg,
               alive_r, render_n=None):
    """DN-Splatter loss stack on rendered outputs -> (total, (parts, aux))."""
    lc = cfg.loss
    image_gt = data.images[cam_idx]
    mask = data.masks[cam_idx][..., None] if data.masks is not None else None

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
        d = depth_term(data.sensor_depths[cam_idx])
        parts["sensor_depth"] = d
        total = total + lc.sensor_depth_lambda * d
    if data.mono_depths is not None and lc.mono_depth_lambda > 0:
        d = depth_term(data.mono_depths[cam_idx])
        parts["mono_depth"] = d
        total = total + lc.mono_depth_lambda * d
    if lc.smooth_lambda > 0:
        sm = (L.edge_aware_tv(out.depth, image_floor)
              if lc.use_depth_smooth_edge_aware else L.tv_loss(out.depth))
        parts["smooth"] = sm
        total = total + lc.smooth_lambda * sm
    if lc.normal_lambda > 0:
        if data.normals is not None and lc.normal_supervision == "mono":
            gt_n = data.normals[cam_idx]
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
        gen = torch.Generator(device=out.depth.device).manual_seed(step)
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

    def lookup(self, v: int, make):
        need = self.age[v] >= self.refresh
        if need:
            self.bins[v] = make()
        self.age = [a + 1 for a in self.age]
        if need:
            self.age[v] = 1
        return self.bins[v]


def bin_view(cfg: ExperimentConfig, camera: Camera, gaussians: GaussianState,
             v: int, render_n: Optional[int],
             cam_delta: Optional[torch.Tensor] = None):
    """Project view v with the current params (and its current pose delta)
    and build its flat layout."""
    rc = cfg.model.rasterize
    grid = TileGrid(camera.width, camera.height, rc.tile_size)
    B = rc.pallas_chunk
    PB = R.pair_budget(rc, grid)
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
        proj = project_gaussians(means, quats, scales, op, cam_v,
                                 near=rc.near, far=rc.far, eps2d=rc.eps2d,
                                 antialiased=rc.antialiased,
                                 radius_clip=rc.radius_clip)
        return flat_bin_gaussians(
            proj.mean2d, proj.radius, proj.depth, width=camera.width,
            height=camera.height, tile_size=rc.tile_size, pair_budget=PB,
            max_tiles_per_gaussian=rc.max_tiles_per_gaussian, block=B,
            compute_landing=rc.flat_grad_transpose != "scatter",
            expand_budget=auto_expand_budget(PB, N, rc.max_tiles_per_gaussian,
                                             B))


def _keep_adam(ok: torch.Tensor, new: AdamState, old: AdamState) -> AdamState:
    """new where the step is finite, else old (every field)."""
    pick = lambda n, o: {k: torch.where(ok, n[k], o[k]) for k in o}  # noqa: E731
    return AdamState(m=pick(new.m, old.m), v=pick(new.v, old.v),
                     acc=pick(new.acc, old.acc),
                     counts=pick(new.counts, old.counts))


def train_step(gaussians: GaussianState, opt: AdamState, cam_state,
               stats: RefineStats, step: int, cam_idx: int, *,
               cfg: ExperimentConfig, camera: Camera, data: TrainData,
               adam_groups=None, render_n: Optional[int] = None,
               cache: Optional[BinCache] = None):
    """One training step -> (gaussians, opt, cam_state, stats, metrics).
    `cfg` must carry the adaptive overrides (patched_cfg); `cache` is the
    chunk's BinCache (flat backend only), or None to bin every step;
    cam_state is (deltas (V, 6), AdamState), updated when
    cfg.train.camera_opt."""
    groups = adam_groups or DEFAULT_GROUPS
    use_cam_opt = cfg.train.camera_opt
    cam_deltas, cam_opt = cam_state
    if cfg.model.binary_opacities:
        adc = cfg.train.adc
        gaussians = gaussians.replace(logit_opacities=binary_opacity_surgery(
            gaussians.logit_opacities, step,
            threshold=cfg.model.binary_opacity_threshold, warmup=adc.warmup,
            skip=adc.reset_alpha_every * adc.refine_every,
            margin=cfg.model.binary_opacity_margin))
    fb = None
    if cache is not None:
        delta_v = cam_deltas[cam_idx] if use_cam_opt else None
        fb = cache.lookup(cam_idx, lambda: bin_view(
            cfg, camera, gaussians, cam_idx, render_n, cam_delta=delta_v))

    old = gaussians.params()
    params = {k: v.detach().requires_grad_(True) for k, v in old.items()}
    deltas = cam_deltas.detach().requires_grad_(use_cam_opt)
    cap = gaussians.capacity
    dev = gaussians.device
    # the kernel backends (pallas, flat) surface gsplat's absgrad through
    # table cols 6-7, and densification reads it; the "jax" backend has no
    # such tap and falls back to the signed screen-position gradient. Only
    # the tap that is read is differentiated.
    use_absgrad = cfg.model.rasterize.backend in ("pallas", "flat")
    tap = torch.zeros((cap, 2), device=dev, requires_grad=not use_absgrad)
    abs_tap = torch.zeros((cap, 2), device=dev, requires_grad=use_absgrad)
    loss, (_, aux) = compute_losses(
        gaussians.replace(**params), camera, data, cam_idx, step, cfg, tap,
        absgrad_tap=abs_tap, render_n=render_n, bins=fb,
        cam_delta=deltas[cam_idx] if use_cam_opt else None)
    leaves = list(params.values()) + [abs_tap if use_absgrad else tap]
    if use_cam_opt:
        leaves.append(deltas)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    n = len(params)
    param_grads = dict(zip(params.keys(), grads[:n]))
    tap_grad = grads[n]

    # non-finite guard: skip the whole update on a NaN/inf loss or gradient
    # (the pose deltas' too), decided on the device (no host sync)
    ok = torch.isfinite(loss.detach())
    for g in grads[:n] + grads[n + 1:]:
        ok = ok & torch.all(torch.isfinite(g))
    tap_grad = torch.where(ok, tap_grad, torch.zeros_like(tap_grad))

    new_p, opt2 = adam_step(old, param_grads, opt, step, gaussians.alive,
                            groups=groups)
    new_p = {k: torch.where(ok, new_p[k], old[k]) for k in old}
    opt2 = _keep_adam(ok, opt2, opt)
    gaussians2 = gaussians.replace(**new_p)

    if use_cam_opt:
        # accumulated, bias-corrected Adam on the (V, 6) pose deltas
        cam_group = {"cam_delta": GroupSpec(
            cfg.train.camera_opt_lr, every_k=cfg.train.camera_opt_every_k,
            eps=1e-8)}
        cam_p, cam_opt2 = adam_step(
            {"cam_delta": cam_deltas}, {"cam_delta": grads[-1]}, cam_opt,
            step, torch.ones(cam_deltas.shape[0], dtype=torch.bool,
                             device=dev), groups=cam_group)
        cam_deltas = torch.where(ok, cam_p["cam_delta"], cam_deltas)
        cam_opt = _keep_adam(ok, cam_opt2, cam_opt)

    radius = aux["radius"].detach()
    if radius.shape[0] < cap:
        radius = torch.cat([radius, torch.zeros(cap - radius.shape[0],
                                                device=dev)])
    st = accumulate_stats(stats, tap_grad, radius, camera.width, camera.height)
    stats2 = RefineStats(
        **{k: torch.where(ok, v, getattr(stats, k))
           for k, v in st.fields().items()})
    metrics = {"loss": loss.detach(), "psnr": aux["psnr"].detach(),
               "overflow": aux["overflow"], "trunc_by_win": aux["trunc_by_win"],
               "pairs_used": aux["pairs_used"],
               "nonfinite": (~ok).to(torch.int32)}
    return gaussians2, opt2, (cam_deltas, cam_opt), stats2, metrics


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
        self._nf_acc = None
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
        T = self._grid_tiles
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

    def _refine_due(self, step: int) -> bool:
        adc = self.cfg.train.adc
        return (step >= adc.warmup and step < adc.stop_split_at
                and (step - adc.warmup) % adc.refine_every == 0)

    def refine_boundary(self) -> Optional[dict]:
        """The host side between chunks: the ADC refine when one is due at
        this step, then the extra callbacks, then the recompact whenever the
        alive set can have changed (slots past render_n are never
        rasterized). Returns the refine's info (device tensors) or None."""
        cfg = self.cfg
        info = None
        changed = False
        if self._refine_due(self.step):
            # the JAX trainer's seed: seed * 1_000_003 + step, as uint32
            seed = (cfg.train.seed * 1_000_003 + self.step) % (1 << 32)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = split_noise(gen, cfg.train.adc.n_split_samples,
                                self.gaussians.capacity, self.device)
            self.gaussians, self.opt, self.stats, info = refine(
                self.gaussians, self.opt, self.stats, noise, cfg.train.adc,
                self.step, scene_scale=self.scene_scale)
            changed = True
        for cb in self.extra_callbacks:
            changed |= bool(cb(self))
        if changed and cfg.train.render_prefix:
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
        raise NotImplementedError(
            "run_fused is not ported (ROADMAP N2: pair it with CUDA graphs)")

    def sync_policies(self, metrics=None):
        raise NotImplementedError("sync_policies is not ported (ROADMAP N2)")

    def run(self, iterations: Optional[int] = None, log=print):
        cfg = self.cfg
        total = iterations if iterations is not None else cfg.train.iterations
        adc = cfg.train.adc
        refresh = cfg.train.bin_refresh_steps
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
            cfg_p = patched_cfg(cfg, self.tile_capacity, self.cover_tiles)
            cache = (BinCache(self.num_views, refresh)
                     if refresh > 0 and self._is_flat else None)
            nonfinite = []
            for _ in range(n):
                (self.gaussians, self.opt, self.cam_state, self.stats,
                 metrics) = train_step(
                    self.gaussians, self.opt, self.cam_state, self.stats,
                    self.step, self.step % self.num_views, cfg=cfg_p,
                    camera=self.camera, data=self.data,
                    adam_groups=self._adam_groups, render_n=self.render_n,
                    cache=cache)
                nonfinite.append(metrics["nonfinite"])
                self.step += 1
            nf_c = torch.stack(nonfinite).sum()
            self._nf_acc = nf_c if self._nf_acc is None else self._nf_acc + nf_c

            self.refine_boundary()
            if (self.image_log_dir is not None
                    and self.step % cfg.train.log_every == 0):
                self._dump_debug_grid()
            if (self.checkpoint_dir is not None
                    and self.step % cfg.train.steps_per_save == 0):
                self.save(f"{self.checkpoint_dir}/ckpt_{self.step}")

            if self.step % cfg.train.log_every == 0 or self.step >= total:
                # one host read for all logged scalars
                vals = torch.stack([
                    metrics["loss"].double(), metrics["psnr"].double(),
                    metrics["overflow"].double(),
                    metrics["pairs_used"].double(),
                    self._nf_acc.double(),
                    self.gaussians.num_alive.double(),
                    *metrics["trunc_by_win"].double()]).tolist()
                loss_h, psnr_h, ovf_h, pu_h, nf_h, n_alive = vals[:6]
                tbw_h = [int(x) for x in vals[6:]]
                self._nf_acc = None
                if int(nf_h) and log:
                    log(f"WARNING: skipped {int(nf_h)} non-finite step(s) "
                        f"since the last log (now at step {self.step})")
                rec = {
                    "step": self.step, "loss": loss_h, "psnr": psnr_h,
                    "num_gaussians": int(n_alive),
                    "tile_overflow": int(ovf_h),
                    "nonfinite_steps": int(nf_h),
                    "capacity": self.gaussians.capacity,
                    "pairs_used": int(pu_h),
                    "elapsed_s": time.time() - t0,
                }
                if self.auto_capacity:
                    cap = pick_capacity(int(n_alive), self.gaussians.capacity,
                                        self.max_capacity,
                                        minimum=min(1024, self.max_capacity))
                    if cap != self.gaussians.capacity:
                        self.gaussians, self.opt, self.stats = (
                            resize_train_state(self.gaussians, self.opt,
                                               self.stats, new_capacity=cap))
                if cfg.train.render_prefix:
                    self._recompact(int(n_alive))
                self._maybe_bump_tile_capacity(int(ovf_h))
                self._maybe_resize_pair_budget(int(pu_h))
                self._maybe_adjust_cover_window(tbw_h)
                self.history.append(rec)
                if log:
                    log(f"step {rec['step']:6d}  loss {rec['loss']:.4f}  "
                        f"psnr {rec['psnr']:.2f}  n {rec['num_gaussians']}")
        return self.history

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
