"""The comparison that decides `correct`.

What the run kept of the program's own work (harness.start_rows,
checked_steps and warm_to_boundary) is held against the plain reference:

- start_rows: the Trainer as built from the seed cloud (the start), the
  slots that differ from the cloud it was handed (exact: 0);
- loss_gap: from the state the timed window ended on (just after a refine
  boundary), the three steps the same Trainer runs next, against the
  reference's three steps from that state: the largest relative gap of
  their losses;
- grad_gap: the first of those steps' gradient as the program's Adam holds
  it after the step ((m1 - b1 m0) / (1 - b1) less the accumulator before,
  or the accumulator's growth in an every_k group that does not apply),
  by the worst leaf: the gap of the two norms over the larger of the
  reference leaf's norm and the median leaf's;
- change_gap: the same of each leaf's change over the three steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by Adam's round-off alone);
- boundary_flags: at two refine boundaries, the warm one that ends set-up
  and the first after the checked steps (ADC refine, touch step,
  compaction), each run by the reference from the program's state just
  before it: the slots whose alive or frozen flag differs, summed (exact:
  0);
- boundary_gap: over the slots alive in both, the largest gap of any
  parameter or Adam moment, over its magnitude plus the field's median
  magnitude, the larger of the two boundaries (exact: 0).
The reference cannot follow the program from the start (float chaos, and
the pair budget the program drops pairs under until its policy has sized
it), so the steps and boundaries it checks start from the program's own
state, and the start is checked by itself.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from fsbench.reference import refine as RF
from fsbench.reference.step import LEAVES, train

B1 = 0.9
FIELDS = LEAVES
NAMES = ("start_rows", "loss_gap", "grad_gap", "change_gap",
         "boundary_flags", "boundary_gap")


def limits(workload: str, root: Path) -> dict:
    """{name: limit} of the cell's limits file; a name whose limit is null
    is not compared in the cell. Without the file every number gets -1,
    which no reading meets."""
    path = root / "limits" / f"{workload}.json"
    if not path.exists():
        return {k: -1.0 for k in NAMES}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(tree[k].double().cpu())) for k in LEAVES}


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def program_grad(steps: dict, cfg: dict) -> dict:
    """The first checked step's gradient, worked out from Adam's state."""
    s0, a0, a1 = steps["start"]["step"], steps["start"]["adam"], steps["after1"]
    out = {}
    for k in LEAVES:
        every = cfg["optimizer"][k]["every_k"]
        if every <= 1 or (s0 + 1) % every == 0:
            out[k] = (a1["m"][k] - B1 * a0["m"][k]) / (1 - B1) - a0["acc"][k]
        else:
            out[k] = a1["acc"][k] - a0["acc"][k]
    return out


def step_readings(prog: dict, ref: dict, params0: dict) -> dict:
    """prog: losses, grad1, params (host, the start's alive rows); ref: the
    reference's train() from the same start."""
    if prog["params"] is None:
        return dict(loss_gap=math.inf, grad_gap=math.inf, change_gap=math.inf)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                        ref["losses"]))
    gp, gr = _norms(prog["grad1"]), _norms(ref["grad1"])
    med = _median(gr.values())
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], med) for k in LEAVES)
    p0 = {k: v.detach().cpu() for k, v in params0.items()}
    dp = _norms({k: prog["params"][k] - p0[k] for k in LEAVES})
    dr = _norms({k: ref["params"][k].cpu() - p0[k] for k in LEAVES})
    moved = [k for k in LEAVES if gr[k] >= 1e-3 * med]
    med_d = _median([dr[k] for k in moved])
    change_gap = max(abs(dp[k] - dr[k]) / max(dr[k], med_d, 1e-30)
                     for k in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def leaf_norms(prog: dict, ref: dict) -> dict:
    """Per leaf: the program's and the reference's first-gradient norms."""
    gp, gr = _norms(prog["grad1"]), _norms(ref["grad1"])
    return {k: [gp[k], gr[k]] for k in LEAVES}


def refine_noise(cfg: dict, seed: int, step: int, capacity: int, dev):
    """The split children's normals: the stream a generator seeded with
    train seed * 1,000,003 + step (as uint32) draws on the device."""
    s = ((seed % (1 << 31)) * 1_000_003 + step) % (1 << 32)
    gen = torch.Generator(device=dev).manual_seed(s)
    n = max(cfg["adc"]["n_split_samples"], 2)
    return torch.randn((n, capacity, 3), generator=gen, device=dev)


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(dev) if torch.is_tensor(tree) else tree)


def reference_boundary(warm: dict, cfg: dict, seed: int, patches: list, dev,
                       control: bool = False) -> dict:
    pre = _to(warm["pre"], dev)
    noise = refine_noise(cfg, seed, warm["step"], pre["means"].shape[0], dev)
    return RF.boundary(pre, cfg, warm["step"], noise, warm["touch"], patches,
                       control)


def boundary_readings(prog: dict, ref: dict) -> dict:
    """One boundary: the program's state after it against the reference's."""
    if prog["alive"].shape != ref["alive"].shape:
        n = float(max(prog["alive"].shape[0], ref["alive"].shape[0]))
        return dict(boundary_flags=n, boundary_gap=math.inf)
    ra, rf = ref["alive"].cpu(), ref["frozen"].cpu()
    flags = float(torch.sum((prog["alive"] != ra) | (prog["frozen"] != rf)))
    both = prog["alive"] & ra
    gap = 0.0
    for group in (None, "m", "v", "acc"):
        for k in FIELDS:
            p = prog[k] if group is None else prog[group][k]
            r = ref[k] if group is None else ref[group][k]
            p, r = p[both].double(), r.cpu()[both].double()
            if p.numel() == 0:
                continue
            scale = float(torch.median(torch.abs(r)))
            d = torch.abs(p - r) / (torch.abs(r) + scale + 1e-30)
            gap = max(gap, float(d.max()))
    return dict(boundary_flags=flags, boundary_gap=gap)


def reference_steps(steps: dict, scn: dict, cfg: dict, dev,
                    control: bool = False) -> dict:
    scene = dict(cams=scn["cams"], images=scn["images"], depths=scn["depths"],
                 normals=scn["normals"])
    st = steps["start"]
    return train(_to(st["params"], dev), scene, cfg, len(steps["losses"]),
                 control, start=st["step"], adam=_to(st["adam"], dev))


def boundaries(pairs) -> dict:
    """The numbers of several boundaries: flags summed, the gap's largest."""
    rs = [boundary_readings(p, r) for p, r in pairs]
    return dict(boundary_flags=sum(r["boundary_flags"] for r in rs),
                boundary_gap=max(r["boundary_gap"] for r in rs))


def readings(start: float, steps: dict, warms: list, scn: dict, cfg: dict,
             seed: int, dev) -> dict:
    """The program's numbers against the reference."""
    prog = dict(losses=steps["losses"], grad1=program_grad(steps, cfg),
                params=steps["params"])
    ref = reference_steps(steps, scn, cfg, dev)
    out = dict(start_rows=start)
    out.update(step_readings(prog, ref, steps["start"]["params"]))
    out.update(boundaries(
        (w["post"], reference_boundary(w, cfg, seed, scn["patches"], dev))
        for w in warms))
    out["leaves"] = leaf_norms(prog, ref)
    return out


def _as_program(ref: dict) -> dict:
    return dict(losses=ref["losses"],
                grad1={k: v.cpu() for k, v in ref["grad1"].items()},
                params={k: v.cpu() for k, v in ref["params"].items()})


def control_readings(steps: dict, warms: list, scn: dict, cfg: dict,
                     seed: int, dev) -> dict:
    """The control's numbers: the reference in TF32 put in the program's
    place, against the reference in float32."""
    ref = reference_steps(steps, scn, cfg, dev)
    prog = _as_program(reference_steps(steps, scn, cfg, dev, control=True))
    out = dict(start_rows=0.0)
    out.update(step_readings(prog, ref, steps["start"]["params"]))
    out.update(boundaries(
        (_to(reference_boundary(w, cfg, seed, scn["patches"], dev,
                                control=True), "cpu"),
         reference_boundary(w, cfg, seed, scn["patches"], dev))
        for w in warms))
    out["leaves"] = leaf_norms(prog, ref)
    return out


def half_scene(scn: dict) -> dict:
    """The scene with the bottom half of every view's pixels left out: a
    loss whose mean runs over the top half alone."""
    h = scn["cams"]["height"] // 2
    return dict(scn, cams=dict(scn["cams"], height=h),
                images=scn["images"][:, :h], depths=scn["depths"][:, :h],
                normals=scn["normals"][:, :h])


def fault_readings(steps: dict, warms: list, scn: dict, cfg: dict,
                   seed: int, dev) -> dict:
    """The faults a training cell can have, read at the cell's own size
    against the reference: half of the batch left out (the reference on
    the top half of each view in the program's place), a refine boundary
    left out (the state before each boundary in place of the one after).
    A step that returns its state unchanged reads change_gap 1 by the
    measure itself."""
    ref = reference_steps(steps, scn, cfg, dev)
    half = _as_program(reference_steps(steps, half_scene(scn), cfg, dev))
    out = {"half_batch": step_readings(half, ref, steps["start"]["params"])}
    out["refine_left_out"] = boundaries(
        (w["pre"], reference_boundary(w, cfg, seed, scn["patches"], dev))
        for w in warms)
    return out


def check(start: float, steps: dict, warms: list, scn: dict, cfg: dict,
          seed: int, dev, lim: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell compares (its
    limit not null); a number missing from `lim` gets limit -1, which no
    reading meets."""
    vals = readings(start, steps, warms, scn, cfg, seed, dev)
    return {k: {"value": vals[k], "limit": lim.get(k, -1.0)} for k in NAMES
            if lim.get(k, -1.0) is not None}
