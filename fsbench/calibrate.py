"""Readings that the limits of `correct` are set from (not run by a cell).

    python3 fsbench/calibrate.py --workload <name> --seconds <s> \
        --seeds 1 2 3 ... [--control 3]

For each seed, a run as harness.run_cell makes it (the same set-up and warm
boundary, a window of --seconds, the checked steps and boundary after it),
then the program's numbers against the reference; for the first
`--control` seeds also the control's (the reference in TF32 put in the
program's place) and the faults' (correct.fault_readings). One JSON line
per seed on standard output, and one summary line: each number's largest
sound reading and the control's smallest.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import fsbench.run  # noqa: E402,F401  (the cache directories, before torch)


def seed_readings(workload: str, seed: int, control: bool, seconds: float,
                  device=None, shrink: dict | None = None) -> dict:
    from fsbench import correct as C
    from fsbench import harness as H

    su = H.set_up(workload, seed, device=device, shrink=shrink)
    tr, cfg, scn, dev = su["tr"], su["cfg"], su["scn"], su["dev"]
    win = H.window(tr, seconds, dev)
    post = H.after_window(tr, su["callbacks"], dev)
    start, steps = su["start"], post["steps"]
    warms = [su["warm"], post["boundary"]]
    hist = [{k: h[k] for k in ("step", "loss", "num_gaussians",
                               "tile_overflow", "pairs_used")}
            for h in tr.history]
    policy = dict(cover_tiles=tr.cover_tiles, tile_capacity=tr.tile_capacity,
                  render_n=tr.render_n, capacity=tr.gaussians.capacity)
    del tr, su
    out = {"seed": seed,
           "program": C.readings(start, steps, warms, scn, cfg, seed, dev),
           "history": hist[-3:], "policy_at_end": policy,
           "window_steps": win["window_steps"],
           "cover_at_checked_steps": steps["cover"],
           "alive_at_boundaries": [[w["step"], int(w["pre"]["alive"].sum()),
                                    int(w["post"]["alive"].sum())]
                                   for w in warms]}
    if control:
        out["control"] = C.control_readings(steps, warms, scn, cfg, seed,
                                            dev)
        out["faults"] = C.fault_readings(steps, warms, scn, cfg, seed, dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = seed_readings(args.workload, seed, i < args.control,
                          args.seconds)
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    names = [n for n in rows[0]["program"] if n != "leaves"]
    summary = {n: {"lower": max(r["program"][n] for r in rows),
                   "control_min": min((r["control"][n] for r in rows
                                       if "control" in r), default=None)}
               for n in names}
    faults = {f: {n: min(r["faults"][f][n] for r in rows if "faults" in r)
                  for n in rows[0]["faults"][f]}
              for f in rows[0].get("faults", {})}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "faults_min": faults}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
