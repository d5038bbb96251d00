#!/usr/bin/env python3
"""Time the s8 matrix kernels K1 / K2 / K3 of one checkout of the port.

    python3 tools/mxu_s8_ab.py [--root DIR]

Imports ``sventt_tpu_torch`` from ``DIR`` (default: this checkout), builds
its kernels there, and prints one JSON line: the card; the median
milliseconds of one CUDA-graph replay of each s8 tensor-core call at the
2^24 plans' shapes on the flagship modulus with the pair twiddle fused --
K1 ``mxu_ntt`` (256, 65536), K2 ``mxu_ntt_mid`` (256, 256, 256), K3
``mxu_ntt_lane`` (65536, 256) forward and inverse -- each checked bitwise
against its plain version first; and a digest of the machine code of the
s8 kernels (``csrc/ntt_mxu_tc.cu`` built to a cubin, ``cuobjdump -sass``,
each kernel's instructions without its name and addresses), so that two
checkouts whose s8 kernels compile to the same code print the same
digest.  Run it on two checkouts in turns in one call (parent, change,
change, parent) to compare them on one card; the data comes from a fixed
seed, so both see the same inputs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys


def sass_digest(build) -> dict:
    """The number of kernels in the s8 tensor-core source of the checkout
    whose ``_build`` module is ``build``, and a sha256 of their SASS: each
    kernel's instruction text (names, addresses and encodings dropped)
    hashed, the hashes sorted and hashed together."""
    cubin = os.path.join(build.BUILD_DIR, f"s8_ab.{os.getpid()}.cubin")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    try:
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-cubin",
                        os.path.join(build.CSRC, "ntt_mxu_tc.cu"), "-o", cubin],
                       capture_output=True, check=True, timeout=600)
        sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc()), "cuobjdump"), "-sass",
                               cubin], capture_output=True, text=True, check=True, timeout=600).stdout
    finally:
        if os.path.exists(cubin):
            os.remove(cubin)
    kernels = []
    for body in sass.split("Function : ")[1:]:
        code = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", body)
        kernels.append(hashlib.sha256("\n".join(code).encode()).hexdigest())
    return {"kernels": len(kernels),
            "digest": hashlib.sha256("".join(sorted(kernels)).encode()).hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from sventt_tpu_torch import _build
    from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, s64
    from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, Modulus
    from sventt_tpu_torch.ops import ntt_mxu
    from sventt_tpu_torch.ops.twiddle import MontPair

    if not torch.cuda.is_available():
        print("mxu_s8_ab: no CUDA card", file=sys.stderr)
        return 1
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    fc = FieldConsts.from_modulus(mod)
    rng = np.random.default_rng(2026)

    def data(shape):
        return from_numpy(rng.integers(0, mod.modulus, shape, dtype=np.uint64), "cuda")

    def pair(shape):
        w = data(shape)
        return MontPair(w, w * s64(mod.montgomery_inverse))

    fwd, inv = (ntt_mxu.make_mxu_tables(mod, 256, inverse=i, device="cuda") for i in (False, True))
    xl, twl = data((256, 1 << 16)), pair((256, 1 << 16))
    xm, twm = data((256, 256, 256)), pair((256, 256))
    xr, twr = data((1 << 16, 256)), pair((1 << 16, 256))
    calls = {
        "K1 lead 256x65536 pair": (lambda: ntt_mxu.mxu_ntt(xl, fwd, fc, twl),
                                   lambda: ntt_mxu.mxu_plain(xl, fwd, fc, twl)),
        "K2 mid 256x256x256 pair": (lambda: ntt_mxu.mxu_ntt_mid(xm, fwd, fc, twm),
                                    lambda: ntt_mxu.mxu_plain(xm, fwd, fc, twm, mid=True)),
        "K3 lane 65536x256 pair": (lambda: ntt_mxu.mxu_ntt_lane(xr, fwd, fc, twr),
                                   lambda: ntt_mxu.mxu_plain(xr, fwd, fc, twr, lane=True)),
        "K3 lane 65536x256 pair inv": (lambda: ntt_mxu.mxu_ntt_lane(xr, inv, fc, twr),
                                       lambda: ntt_mxu.mxu_plain(xr, inv, fc, twr, lane=True)),
    }
    out = {}
    for key, (kernel, plain) in calls.items():
        if not torch.equal(kernel(), plain()):
            print(f"mxu_s8_ab: {key}: kernel != plain", file=sys.stderr)
            return 1
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            kernel()
        for _ in range(3):
            graph.replay()
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[key] = statistics.median(times)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "ms": out, "s8_sass": sass_digest(_build)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
