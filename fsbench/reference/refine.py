"""One refine boundary in plain torch, on a fixed-capacity store of slots.

Adaptive density control as 3D Gaussian splatting publishes it, with the
rules of a configuration's `adc` group:
- culled: alive, not frozen, opacity below cull_alpha_thresh (and, after the
  first opacity reset, too large in the world or on the screen);
- densified: alive, not frozen, seen, mean screen gradient past
  densify_grad_thresh; split when large (world scale past
  densify_size_thresh or screen radius past split_screen_size), else
  duplicated;
- new rows go to free slots in slot order, duplicates first, then the split
  children 1..n-1; a request past the free slots is dropped; child 0 takes
  the original's slot only where its siblings were placed; children draw
  their offsets as R (noise * scale) and shrink their scales by
  split_scale_shrink; new rows start with zero Adam moments; the stats
  start again from zero.
Then FusionSense's touch step: at the anchoring boundary every patch culls
the non-frozen Gaussians inside its oriented box and writes its points as
frozen Gaussians (logit opacity 12, scale gel_scale with a third along z,
+z turned onto the patch normal, the colour of the nearest surviving
Gaussian); at later boundaries intruders into a box are culled again.
Last, the alive slots move to the front in slot order.
"""
from __future__ import annotations

import math

import torch

from fsbench.reference.render import mm, quat_to_rotmat, tf32
from fsbench.scene import rotation_between

MOMENTS = ("m", "v", "acc")


def _place(store: dict, src_rows: torch.Tensor, values: dict):
    """Write one row per request into the free slots, in slot order, as
    far as they go -> (granted mask over src_rows)."""
    free = torch.nonzero(~store["alive"])[:, 0]
    n = min(free.shape[0], src_rows.shape[0])
    dest = free[:n]
    for k, val in values.items():
        store[k][dest] = val[:n]
    for mom in MOMENTS:
        for k in store[mom]:
            store[mom][k][dest] = 0
    store["alive"][dest] = True
    granted = torch.zeros(src_rows.shape[0], dtype=torch.bool,
                          device=src_rows.device)
    granted[:n] = True
    return granted


def refine(store: dict, adc: dict, step: int, noise: torch.Tensor,
           control: bool) -> dict:
    """The ADC pass on a store (params, alive, frozen, m/v/acc dicts,
    stats) at host step `step`; `noise` (n_split, C, 3) standard normals.
    Returns the new store (its tensors new)."""
    s = {k: (v.clone() if torch.is_tensor(v) else
             {kk: vv.clone() for kk, vv in v.items()})
         for k, v in store.items()}
    st = s.pop("stats")
    active = s["alive"] & ~s["frozen"]
    can_split = step < adc["stop_split_at"]
    avg = st["grad2d_acc"] / torch.clamp_min(st["count"], 1)
    high = active & (st["count"] > 0) & (avg > adc["densify_grad_thresh"])
    if not can_split:
        high = torch.zeros_like(high)
    max_scale = torch.amax(torch.exp(s["log_scales"]), -1)
    screen = step < adc["stop_screen_size_at"]
    big = max_scale > adc["densify_size_thresh"]
    if screen:
        big = big | (st["max_radius"] > adc["split_screen_size"])
    split, dup = high & big, high & ~big
    cull = active & (torch.sigmoid(s["logit_opacities"])
                     < adc["cull_alpha_thresh"])
    if step > adc["warmup"] + adc["reset_alpha_every"] * adc["refine_every"]:
        too_big = max_scale > adc["cull_scale_thresh"]
        if screen:
            too_big = too_big | (st["max_radius"] > adc["cull_screen_size"])
        cull = cull | (active & too_big)
    s["alive"] = s["alive"] & ~cull

    keys = ("means", "quats", "log_scales", "logit_opacities", "features_dc",
            "features_rest", "normals")
    orig = {k: store[k] for k in keys}
    R = quat_to_rotmat(orig["quats"])
    shrink = math.log(adc["split_scale_shrink"])

    def child(i, rows):
        local = noise[i][rows] * torch.exp(orig["log_scales"][rows])
        c = {k: orig[k][rows] for k in keys}
        c["means"] = orig["means"][rows] + mm("nij,nj->ni", R[rows], local,
                                              control)
        c["log_scales"] = orig["log_scales"][rows] - shrink
        return c

    d_rows = torch.nonzero(dup)[:, 0]
    _place(s, d_rows, {k: orig[k][d_rows] for k in keys})
    s_rows = torch.nonzero(split)[:, 0]
    placed = torch.ones(s_rows.shape[0], dtype=torch.bool,
                        device=s_rows.device)
    for i in range(1, adc["n_split_samples"]):
        placed = placed & _place(s, s_rows, child(i, s_rows))
    first = s_rows[placed]
    for k, val in child(0, first).items():
        s[k][first] = val

    idx = (step - adc["warmup"]) // adc["refine_every"]
    if idx > 0 and idx % adc["reset_alpha_every"] == 0 and can_split:
        reset = math.log(2 * adc["cull_alpha_thresh"]
                         / (1 - 2 * adc["cull_alpha_thresh"]))
        lo = s["logit_opacities"]
        s["logit_opacities"] = torch.where(s["alive"] & ~s["frozen"],
                                           torch.clamp_max(lo, reset), lo)
        s["m"]["logit_opacities"].zero_()
        s["v"]["logit_opacities"].zero_()
    s["stats"] = {k: torch.zeros_like(v) for k, v in st.items()}
    return s


def in_boxes(points: torch.Tensor, boxes: dict, control: bool) -> torch.Tensor:
    local = mm("bij,nbj->nbi", boxes["rots"],
               points[:, None, :] - boxes["centers"][None], control)
    return torch.any(torch.all(torch.abs(local) <= boxes["extents"][None], -1),
                     -1)


def boxes_of(patches: list, device) -> dict:
    def stack(k):
        return torch.stack([torch.as_tensor(p[k], device=device)
                            for p in patches])
    return dict(centers=stack("bbox_center"), rots=stack("bbox_rot"),
                extents=stack("bbox_extent"))


def anchor(store: dict, patches: list, gel_scale: float,
           control: bool) -> dict:
    """Anchor every patch at once (cull intruders, write frozen rows)."""
    s = store
    dev = s["means"].device
    boxes = boxes_of(patches, dev)
    cat = lambda k: torch.cat([torch.as_tensor(p[k], device=dev)  # noqa: E731
                               for p in patches])
    pts, nrm = cat("points"), cat("normals")
    P = pts.shape[0]
    s["alive"] = s["alive"] & ~(in_boxes(s["means"], boxes, control)
                                & ~s["frozen"])
    a, b = (tf32(pts), tf32(s["means"])) if control else (pts, s["means"])
    d2 = (torch.sum(pts ** 2, -1)[:, None] - 2 * a @ b.T
          + torch.sum(s["means"] ** 2, -1)[None, :])
    d2 = torch.where(s["alive"][None, :], d2, torch.full_like(d2, math.inf))
    nn = torch.min(d2, dim=-1).indices
    free = torch.nonzero(~s["alive"])[:, 0][:P]
    n = free.shape[0]
    ez = torch.zeros_like(nrm)
    ez[:, 2] = 1.0
    rows = dict(means=pts, quats=rotation_between(ez, nrm),
                log_scales=torch.log(torch.tensor(
                    [gel_scale, gel_scale, gel_scale / 3.0],
                    device=dev)).expand(P, 3),
                logit_opacities=torch.full((P,), 12.0, device=dev),
                features_dc=s["features_dc"][nn],
                features_rest=torch.zeros((P,) + s["features_rest"].shape[1:],
                                          device=dev),
                normals=nrm)
    for k, val in rows.items():
        s[k][free] = val[:n]
    for mom in MOMENTS:
        for k in s[mom]:
            s[mom][k][free] = 0
    s["alive"][free] = True
    s["frozen"][free] = True
    return s


def prune(store: dict, patches: list, control: bool) -> dict:
    boxes = boxes_of(patches, store["means"].device)
    store["alive"] = store["alive"] & ~(
        in_boxes(store["means"], boxes, control) & ~store["frozen"])
    return store


def compact(store: dict) -> dict:
    """Alive slots first, in slot order."""
    perm = torch.argsort((~store["alive"]).to(torch.int8), stable=True)
    out = {}
    for k, v in store.items():
        out[k] = ({kk: vv[perm] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[perm])
    return out


def boundary(store: dict, cfg: dict, step: int, noise: torch.Tensor,
             touch: str | None, patches: list, control: bool = False) -> dict:
    """The whole boundary: ADC refine, the touch step ("anchor", "prune" or
    None) and the compaction."""
    s = refine(store, cfg["adc"], step, noise, control)
    if touch == "anchor":
        s = anchor(s, patches, cfg["touch"]["gel_scale"], control)
    elif touch == "prune":
        s = prune(s, patches, control)
    return compact(s)
