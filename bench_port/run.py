"""Runs one cell of BENCHMARK.json and prints its result line.

    python3 bench_port/run.py --workload flagship-2p24.roundtrip \
        --seed 7 --seconds 10 --trace 0

One run is one process: set-up (the kernels' build in the checkout's first
run), warm-up, ``--seconds`` of measured calls, then the check against the
plain reference.  The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error.  ``--trace 1`` profiles the end of the window and reports the
per-layer metrics instead of the end-to-end ones.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench_port", ".cache")


def main(argv=None) -> int:
    # the checkout's root, not this directory, heads the import path
    sys.path[0] = ROOT
    # the bytecode of the modules a run imports stays at a fixed path inside
    # the checkout, so only a checkout's first run writes it: an environment
    # with PYTHONDONTWRITEBYTECODE would otherwise compile it anew in every
    # run (torch's alone takes seconds).  The program keeps its own nvcc
    # build in sventt_tpu_torch/build/, inside the checkout too.
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from bench_port import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
