#!/usr/bin/env python3
"""Write the shipped autotune entries of the card this runs on.

    python3 tools/tune_h100.py [--log2n 17 24] [--cache PATH]

Runs ``plan.autotune.tune(force=True)`` for the flagship transform
(N = 2^64 - 1827*2^31 + 1, g = 3) at each size on CUDA card 0, into
``sventt_tpu_torch/autotune_cache.json`` (or ``--cache``): the staged
search over the three engines, the playoff, the elementwise check of the
winner against the untuned config, and the entry with every candidate's
timing.  Prints the card (``nvidia-smi`` name and power limit) and, per
size, the winner, its ms and the race's seconds; exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log2n", type=int, nargs="+", default=[17, 24])
    p.add_argument("--cache", default=None, help="cache file (default: the shipped one)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("tune_h100: CUDA is not available", file=sys.stderr)
        return 1
    from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
    from sventt_tpu_torch.plan import NttConfig, autotune

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    path = autotune._cache_path(args.cache)
    print(f"card: {smi}; cache: {path}", flush=True)
    for log2n in args.log2n:
        cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << log2n)
        t0 = time.perf_counter()
        best = autotune.tune(cfg, device="cuda:0", force=True, cache_path=args.cache)
        secs = time.perf_counter() - t0
        entry = autotune._load_cache(path)[autotune.cache_key(cfg, "cuda:0")]
        print(f"2^{log2n}: {autotune._tag(best)}: {entry['best_ms']} ms; "
              f"{len(entry['timings'])} timings; race {secs:.1f} s; "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
