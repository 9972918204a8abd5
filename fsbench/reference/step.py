"""Training steps in plain torch: render one view, the objective, autograd,
and Adam per parameter group (Kingma and Ba 2015) with the groups of a
configuration's `optimizer` table: a learning rate (exponentially decayed
from lr_init to lr_final over max_steps where lr_final is given), an
accumulation interval every_k (gradients summed, one bias-corrected update
every k-th step) and eps.

The view of step s is s mod V; the active SH band is min(s // interval,
degree). With binary opacities (DN-Splatter), each step past warmup whose
phase in the opacity-reset period (reset_alpha_every refine intervals) is
past the margin first sets every opacity logit to 1 where it is at least
the threshold and to 0 elsewhere.
"""
from __future__ import annotations

import torch

from fsbench.reference.losses import objective
from fsbench.reference.render import camera, render

B1, B2 = 0.9, 0.999
LEAVES = ("means", "quats", "log_scales", "logit_opacities", "features_dc",
          "features_rest", "normals")


def learning_rate(group: dict, step: int) -> float:
    lr0, lr1 = group["lr_init"], group.get("lr_final")
    if lr1 is None or lr1 == lr0:
        return lr0
    t = min(max(step / group["max_steps"], 0.0), 1.0)
    return lr0 * (lr1 / lr0) ** t


def sh_band(model: dict, step: int) -> int:
    return min(step // model["sh_degree_interval"], model["sh_degree"])


def binary_due(cfg: dict, step: int) -> bool:
    model, adc = cfg["model"], cfg["adc"]
    period = adc["reset_alpha_every"] * adc["refine_every"]
    return bool(model["binary_opacities"]) and step > adc["warmup"] and (
        step - adc["warmup"]) % period > model["binary_opacity_margin"]


def binary_opacities(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    return torch.where(logits >= threshold, torch.ones_like(logits),
                       torch.zeros_like(logits))


def view_inputs(scene: dict, v: int) -> dict:
    return dict(image=scene["images"][v], depth=scene["depths"][v],
                mono_depth=scene["depths"][v], normal=scene["normals"][v])


def loss_and_grads(params: dict, scene: dict, cfg: dict, step: int,
                   control: bool):
    """(loss, {leaf: gradient}) of the step's view."""
    V = scene["images"].shape[0]
    v = step % V
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    p = dict(params, **leaves)
    out = render(p, camera(scene["cams"], v), cfg["raster"],
                 sh_band(cfg["model"], step), control)
    loss = objective(out, p, view_inputs(scene, v), cfg["loss"], control)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(leaves[k]) if g is None else g
                         for k, g in zip(leaves, grads)}


def train(params0: dict, scene: dict, cfg: dict, steps: int,
          control: bool = False, start: int = 0,
          adam: dict | None = None) -> dict:
    """`steps` steps from params0 at step `start`, Adam continuing from
    `adam` (m, v, acc: {leaf: tensor}; counts: {leaf: int}; zeros when None)
    -> losses (per step), grad1 ({leaf: the first step's gradient}), params
    (after the last step)."""
    groups = cfg["optimizer"]
    params = {k: v.clone() for k, v in params0.items()}
    if adam is None:
        adam = dict(m={k: torch.zeros_like(params[k]) for k in LEAVES},
                    v={k: torch.zeros_like(params[k]) for k in LEAVES},
                    acc={k: torch.zeros_like(params[k]) for k in LEAVES},
                    counts={k: 0 for k in LEAVES})
    m = {k: adam["m"][k].clone() for k in LEAVES}
    v2 = {k: adam["v"][k].clone() for k in LEAVES}
    acc = {k: adam["acc"][k].clone() for k in LEAVES}
    count = dict(adam["counts"])
    losses, grad1 = [], None
    for s in range(start, start + steps):
        if binary_due(cfg, s):
            params["logit_opacities"] = binary_opacities(
                params["logit_opacities"],
                cfg["model"]["binary_opacity_threshold"])
        loss, g = loss_and_grads(params, scene, cfg, s, control)
        losses.append(loss)
        if grad1 is None:
            grad1 = g
        for k in LEAVES:
            grp = groups[k]
            acc[k] = acc[k] + g[k]
            if grp["every_k"] > 1 and (s + 1) % grp["every_k"]:
                continue
            count[k] += 1
            m[k] = B1 * m[k] + (1 - B1) * acc[k]
            v2[k] = B2 * v2[k] + (1 - B2) * acc[k] * acc[k]
            mhat = m[k] / (1 - B1 ** count[k])
            vhat = v2[k] / (1 - B2 ** count[k])
            params[k] = params[k] - learning_rate(grp, s) * mhat / (
                torch.sqrt(vhat) + grp["eps"])
            acc[k] = torch.zeros_like(acc[k])
    return dict(losses=losses, grad1=grad1, params=params)
