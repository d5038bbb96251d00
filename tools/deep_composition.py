#!/usr/bin/env python3
"""The distributed six-step over multi-level local plans, against the oracle.

    python3 tools/deep_composition.py [--device cuda|cpu] [--log2n 20] [--shards 8]

``DistributedNTT`` at n = 2^20 (1024 x 1024) on the flagship modulus with
the matrix engine: each shard's column and row transforms are themselves
two-level plans (1024 = 32 x 32), so the composition is three plan levels
deep across the exchanges.  Every comm mode ("xla", "ring", "overlap") runs
the forward and inverse of the ``host_fill`` input on D logical shards of
one device and is held elementwise to the native oracle, with an exact
roundtrip.  Prints one line per mode with its seconds; exits non-zero on a
mismatch.  ``tests/test_torch_parallel.py::test_deep_composition`` runs it
on the CPU (marked slow); on the card it runs the kernels.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

COMMS = ("xla", "ring", "overlap")


def check(device: str, comm: str, log2n: int = 20, shards: int = 8) -> float:
    """One comm mode's forward, inverse and roundtrip against the oracle;
    returns the seconds of the three transforms (host clock, synchronized)."""
    from sventt_tpu_torch import native
    from sventt_tpu_torch.field.limb import to_numpy
    from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
    from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh
    from sventt_tpu_torch.plan import NttConfig, planner
    from sventt_tpu_torch.utils.fill import host_fill

    F, G, n = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << log2n
    dntt = DistributedNTT(NttConfig(F, G, n, strategy="six_step", engine="mxu"),
                          make_ntt_mesh(devices=[device] * shards), comm=comm)
    for plan in (dntt._col_plan, dntt._row_plan):
        if not (isinstance(plan, planner.Split) and plan.row.engine == "mxu"):
            raise AssertionError(f"the local plan {plan} is not a multi-level mxu plan")
    x = host_fill(n, F)
    xs = dntt.shard(x)
    t0 = time.perf_counter()
    fwd = dntt.compute_forward(xs)
    inv = dntt.compute_inverse(xs)
    back = dntt.compute_inverse(fwd)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = [to_numpy(dntt.gather(dntt.normalize(v))) for v in (fwd, inv, back)]
    want = [native.golden_forward(x, F, G), native.golden_inverse(x, F, G), x]
    for name, a, b in zip(("forward", "inverse", "roundtrip"), got, want):
        bad = int(np.count_nonzero(a != b))
        if bad:
            raise AssertionError(f"comm {comm}: {name} differs from the oracle in {bad} elements")
    return secs


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--log2n", type=int, default=20)
    p.add_argument("--shards", type=int, default=8)
    args = p.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("deep_composition: CUDA is not available", file=sys.stderr)
        return 1
    for comm in COMMS:
        secs = check(args.device, comm, args.log2n, args.shards)
        print(f"deep composition 2^{args.log2n} D={args.shards} comm={comm} on {args.device}: "
              f"forward, inverse and roundtrip equal the oracle; {secs:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
