"""The readings that the check's limits are set from, for one cell.

    python3 bench_port/control.py --workload flagship-2p24.roundtrip \
        --seeds 11 12 13 --seconds 1

For each seed, in one process: a short window of the program at the
cell's own size and load, compared as a run compares it (the lower
reading), then the control in the program's place -- the plain reference
with its modular products' quotients taken in float64 -- compared the
same way (the upper reading).  One JSON line each, then the largest
program reading and the smallest control reading of every number.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from bench_port import harness, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    high: dict = {}
    low: dict = {}
    for seed in args.seeds:
        for who, system in (("program", None), ("control", harness.ControlSystem)):
            result, _ = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                                         system=system)
            print(json.dumps({"seed": seed, "who": who, "correct": result["correct"],
                              "attempted": result["attempted"], "checks": result["checks"]}),
                  flush=True)
            for name, c in result["checks"].items():
                (high if who == "program" else low).setdefault(name, []).append(c["value"])
    print(json.dumps({"workload": args.workload,
                      "program_max": {k: max(v) for k, v in high.items()},
                      "control_min": {k: min(v) for k, v in low.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
