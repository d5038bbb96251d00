"""Inter-step (six-step) twiddle tables on int64 tensors.

The PyTorch counterpart of the parts of ``sventt_tpu/ops/twiddle.py`` that
the matrix-NTT path uses: Montgomery-form twiddles ``w = v * 2^64 mod N``
with the companion ``wp = w * N^-1 mod 2^64`` beside them.  Every builder
takes the device its tensors go to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..field.golden import bitreverse_permutation
from ..field.limb import FieldConsts, from_numpy, s64
from ..field.modulus import Modulus


class MontPair(NamedTuple):
    """A Montgomery-form twiddle tensor and its companion (None when dropped)."""

    w: torch.Tensor
    wp: torch.Tensor | None


def montpair_map(f, tw: MontPair) -> MontPair:
    """Apply a tensor transform to both members, keeping a missing companion."""
    return MontPair(f(tw.w), None if tw.wp is None else f(tw.wp))


def _powers(base: int, count: int, N: int) -> list[int]:
    out, x = [], 1
    for _ in range(count):
        out.append(x)
        x = x * base % N
    return out


def _mont_pair(mod: Modulus, values_plain: list[int], device=None) -> MontPair:
    wm = np.array([mod.to_montgomery(v) for v in values_plain], dtype=np.uint64)
    wp = np.array([mod.montgomery_precompute(int(v)) for v in wm], dtype=np.uint64)
    return MontPair(from_numpy(wm, device), from_numpy(wp, device))


def _row_twiddles_host(mod: Modulus, n0: int, n1: int, inverse: bool, device) -> MontPair:
    N = mod.modulus
    omega = mod.get_root_forward(n0 * n1)
    if inverse:
        omega = mod.invert(omega)
    perm = bitreverse_permutation(n0)
    flat = [v for p0 in range(n0) for v in _powers(pow(omega, perm[p0], N), n1, N)]
    tw = _mont_pair(mod, flat, device)
    return montpair_map(lambda a: a.reshape(n0, n1), tw)


def sixstep_row_twiddles(mod: Modulus, n0: int, n1: int, device=None) -> MontPair:
    """The n0 x n1 matrix W[p0, j1] = omega_n^(bitrev(p0)*j1), host-built."""
    return _row_twiddles_host(mod, n0, n1, False, device)


def sixstep_row_twiddles_inverse(mod: Modulus, n0: int, n1: int, device=None) -> MontPair:
    """Inverse inter-step twiddles W[p0, j1] = omega_n^(-bitrev(p0)*j1)."""
    return _row_twiddles_host(mod, n0, n1, True, device)


def sixstep_row_twiddles_device(
    mod: Modulus, n0: int, n1: int, *, inverse: bool = False,
    with_companion: bool = True, modmul: str = "montgomery",
    transposed: bool = False, device=None,
) -> MontPair:
    """Device-built inter-step twiddle matrix for large transforms.

    Same values as ``sixstep_row_twiddles[_inverse]``.  The host computes
    only the n0 Montgomery-form row bases ``omega_n^(+-bitrev(p0))``; the
    device doubles the table log2(n1) times, W[:, k + 2^i] = W[:, k] *
    base^(2^i) for k < 2^i, with the canonical Montgomery multiply -- the
    same canonical values the JAX package's scan recurrence emits, in
    log2(n1) vector steps instead of n1.  ``transposed=True`` returns the
    (n1, n0) matrix W^T, the layout the lead-orientation kernel consumes.
    """
    if modmul != "montgomery":
        raise NotImplementedError(
            f"modmul={modmul!r} twiddles are not ported yet (ROADMAP Queue 1 item 8)"
        )
    if n1 & (n1 - 1):
        raise ValueError("n1 must be a power of two")
    N = mod.modulus
    omega = mod.get_root_forward(n0 * n1)
    if inverse:
        omega = mod.invert(omega)
    perm = bitreverse_permutation(n0)
    fc = FieldConsts.from_modulus(mod, lazy=False)
    bases = np.array(
        [mod.to_montgomery(pow(omega, p, N)) for p in perm], dtype=np.uint64
    )
    step = from_numpy(bases, device)  # base^(2^i), Montgomery form
    wt = torch.full((1, n0), s64(mod.montgomery_r), dtype=torch.int64, device=device)
    while wt.shape[0] < n1:
        wt = torch.cat([wt, fc.mont_mul_full(wt, step[None, :])], dim=0)
        step = fc.mont_mul_full(step, step)
    w = wt if transposed else wt.t().contiguous()
    wp = w * s64(mod.montgomery_inverse) if with_companion else None
    return MontPair(w, wp)
