"""Run one cell of the port's benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up, then ``--seconds`` of rounds, then the check of what the window
produced. The last line of standard output is the result object; the
numbers the check compared, each beside its limit, are the last lines of
standard error. Exits with 2 without a result when the cell's CUDA
devices are missing, and with 3 when a module of the JAX package is
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this directory: the harness's modules are
# imported as ``perfbench.*`` and never shadow a top-level name
sys.path[0] = str(Path(__file__).resolve().parent.parent)
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.NoDevice as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except harness.ForbiddenModules as e:
        print(f"perfbench: modules of the JAX package loaded: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
