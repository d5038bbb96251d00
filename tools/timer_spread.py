#!/usr/bin/env python3
"""The autotuner's timer: its spread over repeats, per chain length.

    python3 tools/timer_spread.py [--repeats 5] [--seconds 0.05 0.1 0.25]

Times the flagship forward of the mxu and pallas engines at 2^17 and 2^24
(and jnp at 0.1 s) as the race does -- ``plan.autotune._time_candidate``:
tables built, the step captured in a CUDA graph, chains of replays of
about ``seconds`` each -- ``repeats`` times per chain length, and prints
each sample, the median and the range (max - min over the median).  The
range at each length is what ``autotune.CHAIN_SECONDS`` was chosen from.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--seconds", type=float, nargs="+", default=[0.05, 0.1, 0.25])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("timer_spread: CUDA is not available", file=sys.stderr)
        return 1
    from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
    from sventt_tpu_torch.plan import NttConfig, autotune

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; CHAIN_SECONDS {autotune.CHAIN_SECONDS}", flush=True)
    for engine in ("mxu", "pallas", "jnp"):
        for log2n in (17, 24):
            cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << log2n, engine=engine)
            for secs in (args.seconds if engine != "jnp" else [0.1]):
                t0 = time.perf_counter()
                xs = [autotune._time_candidate(cfg, secs, device="cuda")
                      for _ in range(args.repeats)]
                med = statistics.median(xs)
                print(f"{engine} 2^{log2n} seconds={secs}: "
                      + ", ".join(f"{v:.5f}" for v in xs)
                      + f" ms; median {med:.5f}, range {100 * (max(xs) - min(xs)) / med:.1f}% "
                      f"({time.perf_counter() - t0:.1f} s for {args.repeats})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
