"""Touch-patch anchoring: insert frozen Gaussians from tactile patches.

Counterpart of fusionsense_tpu/gaussians/touch.py:
- at step `add_touch_at`, for every patch: cull the non-frozen Gaussians
  inside the patch's oriented bbox, then write the patch points into free
  slots as new Gaussians with logit opacity 12, colour = the 1-NN colour of
  the surviving Gaussians, scale = gel_scale (z axis / 3) and quats turning
  +z onto the patch normal,
- the new Gaussians are `frozen`: geometry detached in the forward pass
  (store.activated) and left out of densify/cull (adc.refine),
- every refinement, `touch_prune` re-culls non-frozen intruders that
  drifted into any patch bbox; `hull_prune` culls the shell just off a
  visual hull.
Static shapes as in adc.refine: the patches go into free slots by a stable
rank and only the granted rows are written. Everything stays on the
device; the patches (numpy) are uploaded once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fusionsense_tpu_torch.core.sh import rgb_to_sh0
from fusionsense_tpu_torch.core.transforms import rotation_between
from fusionsense_tpu_torch.data.tactile import TouchPatch
from fusionsense_tpu_torch.gaussians.adc import _write_slots
from fusionsense_tpu_torch.gaussians.store import GaussianState
from fusionsense_tpu_torch.train.optim import AdamState


@dataclasses.dataclass
class TouchBoxes:
    """Stacked oriented bboxes of all patches, on the device."""

    centers: torch.Tensor   # (B, 3)
    rots: torch.Tensor      # (B, 3, 3)
    extents: torch.Tensor   # (B, 3)

    @staticmethod
    def from_patches(patches: list[TouchPatch], device) -> "TouchBoxes":
        stack = lambda name: torch.as_tensor(  # noqa: E731
            np.stack([getattr(p, name) for p in patches]).astype(np.float32),
            device=device)
        return TouchBoxes(centers=stack("bbox_center"), rots=stack("bbox_rot"),
                          extents=stack("bbox_extent"))


def in_any_box(points: torch.Tensor, boxes: TouchBoxes) -> torch.Tensor:
    """(N, 3) -> (N,) True if inside any patch bbox."""
    local = torch.einsum("bij,nbj->nbi", boxes.rots,
                         points[:, None, :] - boxes.centers[None, :, :])
    inside = torch.all(torch.abs(local) <= boxes.extents[None, :, :], dim=-1)
    return torch.any(inside, dim=-1)


def add_touch_patches(state: GaussianState, opt: AdamState,
                      patches: list[TouchPatch], *, gel_scale: float,
                      scene_scale: float = 1.0):
    """Anchor all patches at once -> (state, opt, boxes)."""
    dev = state.device
    boxes = TouchBoxes.from_patches(patches, dev)
    cat = lambda name: torch.as_tensor(  # noqa: E731
        np.concatenate([getattr(p, name) for p in patches]).astype(np.float32),
        device=dev)
    pts, rgb, nrm = cat("points"), cat("colors"), cat("normals")
    P = pts.shape[0]

    # 1. cull the non-frozen Gaussians inside any patch bbox
    intruder = in_any_box(state.means, boxes) & state.alive & ~state.frozen
    alive = state.alive & ~intruder

    # 2. colour of the nearest surviving Gaussian; rgb_to_sh0 of the patch
    #    colour when none is alive. The (P, C) distances stay on the device.
    d2 = (torch.sum(pts ** 2, -1)[:, None] - 2 * pts @ state.means.T
          + torch.sum(state.means ** 2, -1)[None, :])
    d2 = torch.where(alive[None, :], d2, torch.full_like(d2, float("inf")))
    dmin, nn = torch.min(d2, dim=-1)
    has_nn = torch.isfinite(dmin)
    nn_dc = torch.where(has_nn[:, None], state.features_dc[nn], rgb_to_sh0(rgb))

    # 3. write the patch Gaussians into free slots, in slot order
    free_idx = torch.argsort(alive.to(torch.int8), stable=True)
    dest = free_idx[:P]
    ok = torch.arange(P, device=dev) < torch.sum(~alive)

    scale_xy = gel_scale * scene_scale
    log_scales = torch.log(torch.tensor([scale_xy, scale_xy, scale_xy / 3.0],
                                        dtype=torch.float32, device=dev))
    quats = rotation_between(
        torch.tensor([0.0, 0.0, 1.0], device=dev).expand(P, 3), nrm)

    def put(arr, vals):
        return _write_slots(arr, dest, ok, vals)

    one = torch.ones((P,), dtype=torch.bool, device=dev)
    state = state.replace(
        means=put(state.means, pts),
        quats=put(state.quats, quats),
        log_scales=put(state.log_scales, log_scales.expand(P, 3)),
        logit_opacities=put(state.logit_opacities,
                            torch.full((P,), 12.0, device=dev)),
        features_dc=put(state.features_dc, nn_dc),
        features_rest=put(state.features_rest, torch.zeros(
            (P,) + state.features_rest.shape[1:], device=dev)),
        normals=put(state.normals, nrm),
        alive=put(alive, one),
        frozen=put(state.frozen, one),
    )
    zero_put = lambda a: put(a, torch.zeros((P,) + a.shape[1:],  # noqa: E731
                                            dtype=a.dtype, device=dev))
    opt = AdamState(m={k: zero_put(a) for k, a in opt.m.items()},
                    v={k: zero_put(a) for k, a in opt.v.items()},
                    acc={k: zero_put(a) for k, a in opt.acc.items()},
                    counts=opt.counts)
    return state, opt, boxes


def touch_prune(state: GaussianState, boxes: TouchBoxes) -> GaussianState:
    """Re-cull non-frozen Gaussians that drifted into a patch bbox."""
    intruder = in_any_box(state.means, boxes) & state.alive & ~state.frozen
    return state.replace(alive=state.alive & ~intruder)


_BLOCK = 1 << 26     # (candidate, hull) distances per block in hull_prune


def hull_prune(state: GaussianState, hull_points: torch.Tensor, *,
               scene_scale: float = 1.0, inner: float = 0.005,
               outer: float = 0.02,
               center_radius_factor: float = 0.2) -> GaussianState:
    """Visual-hull shell pruning: Gaussians near the hull centre whose
    distance to the nearest hull point falls in (inner, outer] * scale hover
    just off the object surface; cull them. Only the candidates (alive, not
    frozen, near the centre) can be culled, so only their distances are
    computed, in blocks of about _BLOCK (candidate, hull) entries: a hull
    carved at full size holds millions of voxels. Finding the candidates
    reads their count on the host."""
    center = torch.mean(hull_points, dim=0)
    near_center = torch.linalg.norm(state.means - center, dim=-1) < (
        center_radius_factor * scene_scale)
    idx = torch.nonzero(near_center & state.alive & ~state.frozen)[:, 0]
    means = state.means[idx]
    sq_m = torch.sum(means ** 2, -1)
    sq_h = torch.sum(hull_points ** 2, -1)
    M = hull_points.shape[0]
    cols = max(1, min(M, _BLOCK // 1024))
    rows = max(1, _BLOCK // cols)
    d2min = [torch.zeros((0,), device=means.device)]
    for r in range(0, means.shape[0], rows):
        m = means[r:r + rows]
        best = torch.full((m.shape[0],), float("inf"), device=m.device)
        for c in range(0, M, cols):
            d2 = (sq_m[r:r + rows, None] - 2 * m @ hull_points[c:c + cols].T
                  + sq_h[None, c:c + cols])
            best = torch.minimum(best, torch.amin(d2, dim=-1))
        d2min.append(best)
    dmin = torch.sqrt(torch.clamp_min(torch.cat(d2min), 0.0))
    shell = (dmin > inner * scene_scale) & (dmin <= outer * scene_scale)
    cull = torch.zeros_like(state.alive).index_fill_(0, idx[shell], True)
    return state.replace(alive=state.alive & ~cull)
