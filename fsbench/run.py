"""The benchmark of the PyTorch/H100 port: one run of one cell.

    python3 fsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object: correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last `checks`, each number compared beside its limit) and
the same checks as the last lines of standard error. Exits with another
code than 0, and prints no result, when no card is present, when the run
loaded JAX or the JAX package, or when a file it needs is missing.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from fsbench.harness import RunError, run_cell

    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start=T_START)
    except (RunError, ImportError, OSError) as e:
        print(f"fsbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
