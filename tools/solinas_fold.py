#!/usr/bin/env python3
"""The narrow Solinas multiply (csrc/field.cuh solinas_mul) against the
full-word form it replaced, on one card.

    python3 tools/solinas_fold.py [--iters N]

Builds one microbenchmark with nvcc into a temporary directory, holding
field.cuh's narrow multiply (each fold's products at its operands' widths:
14 32 x 32 products) and the full-word form (``FULL_FORM`` below: 64-bit
products in every fold, 24), and on the flagship and Goldilocks moduli:

* checks both on 2^22 random pairs (a any u64, w below N) and on JAX's
  corner values of the fold (0, 1, N - 1, N, 2^63, 2^64 - 1) against the
  twiddles 0, 1, 2, N - 2, N - 1: the two forms bitwise equal, and equal to
  the plain version (``FieldConsts.solinas_mul``) on the same card tensors;
* times each in chains (8 independent chains a thread, 8 blocks of 256
  threads an SM): multiplies a second, in turns full, narrow, narrow, full;
* counts the instructions of each chain kernel's loop body in its SASS
  (cuobjdump, where the toolkit has it; the loop is not unrolled, 8
  multiplies an iteration): all, and the 32-bit multiplies by form --
  IMAD.WIDE(.U32), IMAD.HI(.U32), IMAD (the low word) -- apart from the
  IMAD forms the compiler uses as moves, shifts and additions (.MOV,
  .SHL, .IADD, .X).

The card's name and power limit are printed with the times.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402

#: The full-word Solinas multiply, as field.cuh had it before the narrow
#: folds: 64 x 64 products (mul.lo / mul.hi.u64) in every fold.
FULL_FORM = r"""
__device__ __forceinline__ u64 solinas_mul_full(u64 a, u64 w, u64 N) {
  const u64 eps = 0ull - N;
  u64 c;
  u64 lo = a * w, hi = __umul64hi(a, w);
  lo = add_carry(lo, hi * eps, c);
  hi = __umul64hi(hi, eps) + c;
  lo = add_carry(lo, hi * eps, c);
  hi = __umul64hi(hi, eps) + c;
  u64 r = add_carry(lo, hi * eps, c);
  r += c ? eps : 0ull;
  return u64_min(r, r - N);
}
"""

BENCH = r"""
#include <cuda_runtime.h>
#include "field.cuh"
""" + FULL_FORM + r"""
__global__ void both(const u64 *a, const u64 *w, u64 *narrow, u64 *full, long long n, u64 N) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    narrow[i] = solinas_mul(a[i], w[i], N);
    full[i] = solinas_mul_full(a[i], w[i], N);
  }
}
template <bool NARROW>
__global__ void __launch_bounds__(256) chains(u64 *out, u64 N, u64 w, int iters) {
  u64 v[8];
  for (int i = 0; i < 8; ++i) v[i] = threadIdx.x * 7919ull + blockIdx.x * 104729ull + i;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = NARROW ? solinas_mul(v[i], w, N) : solinas_mul_full(v[i], w, N);
  }
  u64 s = 0;
  for (int i = 0; i < 8; ++i) s ^= v[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int solinas_both(const void *a, const void *w, void *narrow, void *full, long long n,
                            unsigned long long N) {
  both<<<1024, 256>>>((const u64 *)a, (const u64 *)w, (u64 *)narrow, (u64 *)full, n, N);
  return (int)cudaGetLastError();
}
extern "C" float solinas_chains(int narrow, int blocks, int iters, unsigned long long N,
                                unsigned long long w) {
  u64 *out;
  cudaMalloc(&out, (size_t)blocks * 256 * 8);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = 0;
  for (int rep = 0; rep < 2; ++rep) {  // the second run is timed
    cudaEventRecord(a);
    if (narrow)
      chains<true><<<blocks, 256>>>(out, N, w, iters);
    else
      chains<false><<<blocks, 256>>>(out, N, w, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  cudaFree(out);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}
"""


def _build(out_dir: str) -> str:
    from sventt_tpu_torch import _build

    with open(os.path.join(out_dir, "k.cu"), "w") as f:
        f.write(BENCH)
    lib = os.path.join(out_dir, "lib.so")
    p = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build.CSRC,
         os.path.join(out_dir, "k.cu"), "-o", lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"build failed:\n{p.stdout}")
    return lib


def _sass_counts(lib: str) -> dict:
    """{kernel: {"all": instructions, form: count}} of the loop body (the
    instructions between the loop's label and its backward branch) of the
    two chain kernels, or {} where cuobjdump is missing."""
    from sventt_tpu_torch import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    bodies, labels, name, pending = {}, {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = None
            if "chains" in m.group(1):
                name = "narrow" if "ILb1E" in m.group(1) else "full"
            if name:
                bodies[name], labels[name] = [], {}
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if name and lab:
            pending.append(lab.group(1))
            continue
        op = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^/]*)", line)
        if name and op:
            addr = int(op.group(1), 16)
            labels[name].update(dict.fromkeys(pending, addr))
            pending = []
            bodies[name].append((addr, op.group(2), op.group(3)))
    counts = {}
    for name, ins in bodies.items():
        # the loop: from the backward branch's target to the branch
        back = []
        for i, (addr, mn, rest) in enumerate(ins):
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", rest) if mn.startswith("BRA") else None
            if t:
                target = labels[name].get(t.group(1)) if t.group(1) else int(t.group(2), 16)
                if target is not None and target < addr:
                    back.append((i, target))
        if not back:
            continue
        end, target = back[0]
        body = [mn for addr, mn, _ in ins[: end + 1] if addr >= target]
        c = {"all": len(body)}
        for mn in body:
            if mn.startswith("IMAD") and not mn.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD",
                                                             "IMAD.X")):
                c[mn] = c.get(mn, 0) + 1
        counts[name] = c
    return counts


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000, help="multiplies a chain")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solinas_fold: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy
    from sventt_tpu_torch.field.modulus import GOLDILOCKS_MODULUS, Modulus

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    flag, _ = cs.moduli()
    with tempfile.TemporaryDirectory() as tmp:
        path = _build(tmp)
        lib = ctypes.CDLL(path)
        lib.solinas_both.restype = ctypes.c_int
        lib.solinas_both.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_ulonglong]
        lib.solinas_chains.restype = ctypes.c_float
        lib.solinas_chains.argtypes = [ctypes.c_int] * 3 + [ctypes.c_ulonglong] * 2
        sass = _sass_counts(path)
        rng = np.random.default_rng(11)
        for mod, tag in ((flag, "flagship"), (Modulus(GOLDILOCKS_MODULUS, 7), "Goldilocks")):
            N = mod.modulus
            fc = FieldConsts.from_modulus(mod, modmul="solinas")
            corners = [0, 1, N - 1, N, 1 << 63, (1 << 64) - 1]
            a_h = rng.integers(0, 1 << 64, size=1 << 22, dtype=np.uint64)
            w_h = rng.integers(0, N, size=1 << 22, dtype=np.uint64)
            pairs = [(a, w) for a in corners for w in (0, 1, 2, N - 2, N - 1)]
            a_h[: len(pairs)] = [a for a, _ in pairs]
            w_h[: len(pairs)] = [w for _, w in pairs]
            a, w = from_numpy(a_h, "cuda"), from_numpy(w_h, "cuda")
            narrow, full = torch.empty_like(a), torch.empty_like(a)
            rc = lib.solinas_both(a.data_ptr(), w.data_ptr(), narrow.data_ptr(), full.data_ptr(),
                                  a.numel(), N)
            cs.check(rc == 0, f"launch failed: CUDA error {rc}")
            plain = fc.solinas_mul(a, w)
            torch.cuda.synchronize()
            same = torch.equal(narrow, full) and torch.equal(narrow, plain)
            cs.log(f"  {tag}: narrow == full == plain on {a.numel()} pairs "
                   f"({len(pairs)} corner pairs first): {same}")
            cs.check(same, f"{tag}: the narrow Solinas multiply differs")
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            blocks, tw = 8 * sms, int(w_h[len(pairs)])
            ms = {}
            for form in ("full", "narrow", "narrow", "full"):
                ms.setdefault(form, []).append(
                    lib.solinas_chains(int(form == "narrow"), blocks, args.iters, N, tw))
            for form, v in ms.items():
                rate = blocks * 256 * 8 * args.iters / (v[0] * 1e-3)
                cs.log(f"  {tag} {form}: {v[0]:.4f} / {v[1]:.4f} ms, {rate / 1e12:.3f} T "
                       "multiplies/s (first of the two)")
    for form, c in sass.items():
        muls = sum(v for k, v in c.items() if k != "all")
        cs.log(f"  SASS chains<{form}> loop body (8 multiplies): {c['all']} instructions, {muls} "
               f"32-bit multiplies {dict(sorted((k, v) for k, v in c.items() if k != 'all'))}")
    if not sass:
        cs.log("  SASS: cuobjdump not found; instruction counts not measured")
    return 0


if __name__ == "__main__":
    sys.exit(main())
