#!/usr/bin/env python3
"""The u7 tensor-core matrix kernel beside the designs it did not keep.

    python3 tools/mxu_u7_variants.py [--reps N]

Copies the headers of ``sventt_tpu_torch/csrc`` and its u7 source
``ntt_mxu_tc_u7.cu`` into one temporary directory per build, patches each
copy, and compiles them all at once with nvcc (sm_90a, the flags of
``sventt_tpu_torch/_build.py``, ``-Xptxas -v``):

* "as built": unchanged -- all 10 data planes in registers
  (``Tc<true>::BG = 10``) under ``__launch_bounds__(256, 2)``, 128
  registers, two blocks an SM;
* "BG=2": the data planes two at a time, five passes over the matrix
  planes a 32-point step;
* "one block an SM": ``__launch_bounds__(256, 1)``, up to 255 registers;
* "staged": the C entry with the staged lane epilogue (form
  "lane_staged", the inverse with the pair twiddle), which the port builds
  for s8 only.

It prints each build's ``mxu_tc_kernel`` instantiations with their
registers and spill bytes, then times each build against "as built" on the
card, in turns (as built, variant, variant, as built), as the median of
``--reps`` CUDA-graph replays: at the 2^24 shapes K1 ``mxu_ntt`` (256,
65536) with the pair twiddle, K3 ``mxu_ntt_lane`` (65536, 256) without a
twiddle and its inverse with the pair twiddle (the staged build's one
call), each with blocks of 16 columns (``tc_columns``' rule at m = 256)
and 32 (one block an SM by shared memory); and K11's (128, 32768) at 32
columns.  Every build's result is checked bitwise against the plain
version before it is timed.  The first line is the card's name and power
limit.  Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SOURCE = "ntt_mxu_tc_u7.cu"

#: (file, text, replacement) patches of each build's copy.
PATCHES = {
    "as built": (),
    "BG=2": (("mxu_tc.cuh", "static constexpr int BG = U7 ? NPL : 4;",
              "static constexpr int BG = U7 ? 2 : 4;"),),
    "one block an SM": (("mxu_tc.cuh", "static constexpr int MIN_BLOCKS = 2;",
                         "static constexpr int MIN_BLOCKS = U7 ? 1 : 2;"),),
    "staged": ((SOURCE, "return entry<true, false>(", "return entry<true, true>("),),
}

_INST = re.compile(r"mxu_tc_kernelILb1ELi(\d+)ELi(\d)ELb(\d)ELb(\d)ELi(\d)E")


def build(name: str, out_dir: str) -> tuple[str, list[tuple[str, int, int, int]]]:
    """Compile the patched copy ``name`` into a library under ``out_dir``;
    returns its path and (instantiation, registers, spill store bytes,
    spill load bytes) of every mxu_tc_kernel in it."""
    from sventt_tpu_torch import _build

    d = os.path.join(out_dir, name.replace(" ", "_").replace("=", ""))
    os.makedirs(d)
    for path in glob.glob(os.path.join(_build.CSRC, "*.cuh")) + [
            os.path.join(_build.CSRC, SOURCE)]:
        shutil.copy(path, d)
    for fname, old, new in PATCHES[name]:
        path = os.path.join(d, fname)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: patch anchor not found once in {fname}: {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    lib = os.path.join(d, "lib.so")
    log = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", os.path.join(d, SOURCE),
                          "-o", lib], capture_output=True, text=True, timeout=900)
    if log.returncode != 0:
        raise RuntimeError(f"build of {name!r} failed:\n{log.stdout}{log.stderr}")
    rows, entry, spill = [], None, (0, 0)
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry" in line:
            entry = line
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spill = (int(m.group(1)), int(m.group(2)))
        elif entry and "Used" in line and "registers" in line:
            inst = _INST.search(entry)
            if inst:
                nt, tw, inv, lazy, lane = inst.groups()
                label = (f"NT {nt} tw {('none', 'pair', 'w', 'solinas')[int(tw)]} "
                         f"{'inv' if inv == '1' else 'fwd'}{' lazy' if lazy == '1' else ''} "
                         f"{('strided', 'lane', 'lane_staged')[int(lane)]}")
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                rows.append((label, regs, *spill))
            entry, spill = None, (0, 0)
    return lib, rows


def run(entry, x, t, fc, tw, orientation: str, form: str):
    """``mxu_ntt`` / ``mxu_ntt_lane`` of u7 tables ``t`` through the C entry
    ``entry`` of one build, in ``form``, with the block ``t.tc_nt`` (the
    staged form's shared memory added to the lane form's)."""
    import torch

    from sventt_tpu_torch.ops import ntt_mxu

    x3, tw3, back = ntt_mxu._as3(x, tw, t.m, orientation)
    out, head, tail = ntt_mxu._kernel_args(x3, t, fc, tw3, t.tc_planes)
    A, m, B = x3.shape
    geo = ntt_mxu.tc_geometry(m, B, A, torch.cuda.get_device_properties(0).multi_processor_count,
                              "strided" if form == "strided" else "lane", "u7", t.tc_nt)
    smem = geo.smem + (8 * geo.nt * (geo.rg + 2) if form == "lane_staged" else 0)
    rc = entry(*head, *tail, ntt_mxu.TC_FORMS.index(form), geo.nt, geo.split, smem,
               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"u7 kernel launch failed: CUDA error {rc}")
    return back(out)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20, help="CUDA-graph replays a timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mxu_u7_variants: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from sventt_tpu_torch.field.limb import FieldConsts
    from sventt_tpu_torch.ops import ntt_mxu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(PATCHES)) as pool:
            built = dict(zip(PATCHES, pool.map(lambda n: build(n, tmp), PATCHES)))
        entries = {}
        for name, (lib, rows) in built.items():
            for label, regs, st, ld in rows:
                cs.log(f"  {name}: {label}: {regs} registers, spill {st} / {ld} bytes")
            regs = [r[1] for r in rows]
            spilled = [r[2] for r in rows if r[2] or r[3]]
            cs.log(f"[u7 build] {name}: {len(rows)} instantiations, registers "
                   f"{min(regs)}-{max(regs)}, {len(spilled)} spill"
                   + (f" ({min(spilled)}-{max(spilled)} bytes stored)" if spilled else ""))
            fn = ctypes.CDLL(lib).sventt_mxu_ntt_tc_u7
            fn.restype = ctypes.c_int
            fn.argtypes = ntt_mxu._TC_ARGTYPES
            entries[name] = fn

        import numpy as np

        flag, _ = cs.moduli()
        fc = FieldConsts.from_modulus(flag)
        fc0 = FieldConsts.from_modulus(flag, lazy=False)
        rng = np.random.default_rng(12)
        xl = cs.rand_u64(rng, (256, 1 << 16), "cuda", below=flag.modulus)
        twl = cs.rand_twiddle(rng, (256, 1 << 16), flag, "pair", "cuda")
        xr = cs.rand_u64(rng, (1 << 16, 256), "cuda", below=flag.modulus)
        twr = cs.rand_twiddle(rng, (1 << 16, 256), flag, "pair", "cuda")
        x128 = cs.rand_u64(rng, (128, 1 << 15), "cuda", below=flag.modulus)
        fwd, inv = (ntt_mxu.make_mxu_tables(flag, 256, inverse=i, scheme="u7", device="cuda")
                    for i in (False, True))
        t128 = ntt_mxu.make_mxu_tables(flag, 128, inverse=False, scheme="u7", device="cuda")
        # (call, tables, fc, x, tw, orientation, forms of the variants)
        calls = [
            ("K1 lead 256x65536 pair", fwd, fc, xl, twl, "lead", "strided"),
            ("K3 lane 65536x256", fwd, fc, xr, None, "lane", "lane"),
            ("K3 lane 65536x256 pair inv", inv, fc, xr, twr, "lane", "lane"),
            ("K11 lead 128x32768", t128, fc0, x128, None, "lead", "strided"),
        ]
        cs.log(f"[u7 variants] median ms of {args.reps} CUDA-graph replays, in turns: "
               "as built, variant, variant, as built")
        for key, t, f, x, tw, orientation, form in calls:
            plain = ntt_mxu.mxu_plain(x, t, f, tw, lane=orientation == "lane")
            for nt in (16, 32) if t.m == 256 else (32,):
                tn = dataclasses.replace(t, tc_nt=nt)
                variants = [(n, form) for n in PATCHES if n not in ("as built", "staged")]
                if key.endswith("pair inv"):
                    variants.append(("staged", "lane_staged"))
                for name, vform in variants:
                    base = (lambda: run(entries["as built"], x, tn, f, tw, orientation, form))
                    var = (lambda name=name, vform=vform:
                           run(entries[name], x, tn, f, tw, orientation, vform))
                    cs.check(torch.equal(base(), plain), f"{key} nt {nt} as built != plain")
                    cs.check(torch.equal(var(), plain), f"{key} nt {nt} {name} != plain")
                    b1, v1, v2, b2 = (cs.timed_graph(fn, 3, args.reps)
                                      for fn in (base, var, var, base))
                    cs.log(f"  {key} nt {nt}: as built {b1:.4f} / {b2:.4f}, {name} "
                           f"{v1:.4f} / {v2:.4f} ms ({(v1 + v2) / (b1 + b2):.3f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
