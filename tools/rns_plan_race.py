#!/usr/bin/env python3
"""The multi-modular matrix plans of one size, raced on the card.

    python3 tools/rns_plan_race.py [--limbs 32] [--log2n 17 20] [--rounds 5]

For each length, an RNS configuration of ``limbs`` 64-bit primes (the
benchmark's ``rns32-2p17`` ones at 2^17; above, the largest primes q <
2^64 with q = 1 mod n) is planned every way the race names: the matrix
engine's own cut (``engine="mxu"``: leaves of up to 512 points), 512 x
256 by ``plan_spec`` (2^17 only), the left-deep cuts at leaves of up to
256, 128, 64 and 32 points, and ``engine="auto"``'s plan; plans that come
out equal run once, under the names of all.  Each plan's forward and
inverse are captured in a CUDA graph and timed as chains of replays
(``utils.timing.time_chained``), the plans in turns, ``rounds`` times;
each plan's outputs must equal the first plan's word for word, and its
launches and limbs per forward are counted.  Prints the card, each
plan's tree, per-round times and the medians.  Exits non-zero without a
card or on a mismatch.  Every plan's tables are held at once: 32 limbs
at 2^24 exceed the H100's 80 GB (take 8 there).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def primes(limbs: int, log2n: int) -> tuple[tuple, tuple]:
    """``limbs`` primes of 2-adicity >= log2n and their generators: the
    benchmark's at 2^17, else the largest below 2^64."""
    from sventt_tpu_torch.field.modulus import find_ntt_prime

    if log2n == 17:
        cell = json.loads((ROOT / "bench_port" / "configs" / "rns32-2p17.json").read_text())
        return tuple(cell["moduli"][:limbs]), tuple(cell["generators"][:limbs])
    qs, gs, start = [], [], None
    for _ in range(limbs):
        q, g = find_ntt_prime(64, log2n, start=start)
        qs.append(q)
        gs.append(g)
        start = q - 2
    return tuple(qs), tuple(gs)


def plans(qs, gs, n: int) -> dict:
    """name -> NttConfig, one a distinct plan tree; the names of the
    candidates that plan alike are joined."""
    from sventt_tpu_torch.plan import NttConfig
    from sventt_tpu_torch.plan.wrapper import build_config_plan

    cands = {"engine='mxu' (512)": NttConfig(qs, gs, n, engine="mxu")}
    if n == 1 << 17:
        cands["512 x 256 (plan_spec)"] = NttConfig(qs, gs, n, plan_spec="mxu:256,mxu")
    for cap in (256, 128, 64, 32):
        cands[f"max_fused={cap}"] = NttConfig(qs, gs, n, max_fused=cap)
    cands["auto"] = NttConfig(qs, gs, n)
    by_plan: dict = {}
    for name, cfg in cands.items():
        by_plan.setdefault(repr(build_config_plan(cfg, "mxu")), []).append((name, cfg))
    return {" = ".join(name for name, _ in same): same[0][1] for same in by_plan.values()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--limbs", type=int, default=32)
    p.add_argument("--log2n", type=int, nargs="+", default=[17, 20])
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--seconds", type=float, default=0.25)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("rns_plan_race: CUDA is not available", file=sys.stderr)
        return 1
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.plan import NTT
    from sventt_tpu_torch.utils.timing import time_chained

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(20261018)
    ok = True
    for log2n in args.log2n:
        n = 1 << log2n
        qs, gs = primes(args.limbs, log2n)
        # uniform below 2^62: canonical in every limb (each q > 2^63)
        x = torch.randint(0, 1 << 62, (args.limbs, n), device="cuda", generator=gen)
        ntts, want = {}, None
        for name, cfg in plans(qs, gs, n).items():
            ntt = NTT(cfg, device="cuda")
            ntt_mxu.reset_counts()
            fwd = ntt.compute_forward(x)
            torch.cuda.synchronize()
            launches, limbs = ntt_mxu.KERNEL_LAUNCHES["tensor_core"], ntt_mxu.LIMBS["tensor_core"]
            inv = ntt.compute_inverse(x)
            same = want is None or (torch.equal(fwd, want[0]) and torch.equal(inv, want[1]))
            want = want or (fwd, inv)
            ok &= same and torch.equal(ntt.compute_inverse(fwd), x)
            print(f"2^{log2n} {name}: {ntt.plan!r}; a forward {launches} launches, "
                  f"{limbs} limbs; equal to the first plan: {same}", flush=True)
            ntts[name] = ntt
        times = {name: ([], []) for name in ntts}
        for r in range(args.rounds):
            order = list(ntts) if r % 2 == 0 else list(reversed(ntts))
            for name in order:
                for d, step_of in enumerate(("forward_step", "inverse_step")):
                    step, tables = getattr(ntts[name], step_of)()
                    times[name][d].append(time_chained(step, x, tables, seconds=args.seconds).ms)
        for name, (f, i) in times.items():
            print(f"2^{log2n} {args.limbs} limbs {name}: forward "
                  + ", ".join(f"{v:.4f}" for v in f) + f" ms (median {statistics.median(f):.4f}); "
                  "inverse " + ", ".join(f"{v:.4f}" for v in i)
                  + f" ms (median {statistics.median(i):.4f})", flush=True)
        del ntts, x, want
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
