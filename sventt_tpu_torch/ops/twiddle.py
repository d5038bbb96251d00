"""Twiddle tables on int64 tensors.

The PyTorch counterpart of ``sventt_tpu/ops/twiddle.py``:

* inter-step (six-step) twiddles, Montgomery-form ``w = v * 2^64 mod N``
  with the companion ``wp = w * N^-1 mod 2^64`` beside them (of L limbs at
  once, one modulus a limb, ``sixstep_row_twiddles_limbs``), or, for the
  Solinas engine, plain canonical ``w`` without a companion
  (``sixstep_row_twiddles_plain``, the device generator's Solinas mode);
* per-stage butterfly twiddles (``forward_tables`` / ``inverse_tables``) in
  the form of the configured engine: Montgomery as above, Shoup (``w``
  plain, ``wp = floor(w * 2^64 / N)``) or Solinas (``w`` plain, no
  companion: ``wp`` is None, the inverse scale included).

The public builders put their tensors on the CUDA card unless given a
``device``; the private helpers take the device they are given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..field.golden import bitreverse_permutation
from ..field.limb import FieldConsts, from_numpy, mont_mul_by, s64
from ..field.modulus import Modulus
from ..utils.device import resolve_device


class MontPair(NamedTuple):
    """A Montgomery-form twiddle tensor and its companion (None when dropped)."""

    w: torch.Tensor
    wp: torch.Tensor | None


def montpair_map(f, tw: MontPair) -> MontPair:
    """Apply a tensor transform to both members, keeping a missing companion."""
    return MontPair(f(tw.w), None if tw.wp is None else f(tw.wp))


def check_companion(fc: FieldConsts, tw: MontPair | None) -> None:
    """Refuse a companion table under the Solinas engine, whose twiddles
    are plain: a Montgomery table, the kind a companion comes with,
    multiplied by ``solinas_mul`` comes out times 2^64 mod N."""
    if tw is not None and tw.wp is not None and fc.modmul == "solinas":
        raise ValueError("a companion table under modmul='solinas': its twiddles are plain "
                         "(wp must be None)")


def _powers(base: int, count: int, N: int) -> list[int]:
    out, x = [], 1
    for _ in range(count):
        out.append(x)
        x = x * base % N
    return out


def inter_step_mul(fc: FieldConsts, x: torch.Tensor, tw: MontPair) -> torch.Tensor:
    """The inter-step twiddle multiply: ``solinas_mul`` of plain twiddles
    under the Solinas engine (any companion ignored), else Montgomery --
    ``mont_mul`` with the companion, ``mont_mul_full`` without it -- for
    Montgomery and Shoup alike.  Montgomery tables need a Montgomery
    ``fc``: under a Solinas one they come out times 2^64 mod N."""
    if fc.modmul == "solinas":
        return fc.solinas_mul(x, tw.w)
    if tw.wp is None:
        return fc.mont_mul_full(x, tw.w)
    return fc.mont_mul(x, tw.w, tw.wp)


def _mont_pair(mod: Modulus, values_plain: list[int], device) -> MontPair:
    wm = np.array([mod.to_montgomery(v) for v in values_plain], dtype=np.uint64)
    wp = np.array([mod.montgomery_precompute(int(v)) for v in wm], dtype=np.uint64)
    return MontPair(from_numpy(wm, device), from_numpy(wp, device))


def _twiddle_pair(mod: Modulus, values_plain: list[int], modmul: str, device) -> MontPair:
    """Twiddle + companion for the engine ``modmul``: Montgomery
    ``(w*R mod N, w*R*N^-1 mod 2^64)``, Shoup ``(w, floor(w*2^64/N))`` or
    Solinas ``(w, None)``."""
    if modmul == "montgomery":
        return _mont_pair(mod, values_plain, device)
    w = np.array([v % mod.modulus for v in values_plain], dtype=np.uint64)
    if modmul == "solinas":
        return MontPair(from_numpy(w, device), None)
    wp = np.array([mod.shoup_precompute(int(v)) for v in w], dtype=np.uint64)
    return MontPair(from_numpy(w, device), from_numpy(wp, device))


def _row_values(mod: Modulus, n0: int, n1: int, inverse: bool) -> list[int]:
    """W[p0, j1] = omega_n^(+-bitrev(p0)*j1), row-major, as Python ints."""
    N = mod.modulus
    omega = mod.get_root_forward(n0 * n1)
    if inverse:
        omega = mod.invert(omega)
    perm = bitreverse_permutation(n0)
    return [v for p0 in range(n0) for v in _powers(pow(omega, perm[p0], N), n1, N)]


def _row_twiddles_host(mod: Modulus, n0: int, n1: int, inverse: bool, device) -> MontPair:
    tw = _mont_pair(mod, _row_values(mod, n0, n1, inverse), device)
    return montpair_map(lambda a: a.reshape(n0, n1), tw)


def sixstep_row_twiddles(mod: Modulus, n0: int, n1: int, device=None) -> MontPair:
    """The n0 x n1 matrix W[p0, j1] = omega_n^(bitrev(p0)*j1), host-built."""
    return _row_twiddles_host(mod, n0, n1, False, resolve_device(device))


def sixstep_row_twiddles_inverse(mod: Modulus, n0: int, n1: int, device=None) -> MontPair:
    """Inverse inter-step twiddles W[p0, j1] = omega_n^(-bitrev(p0)*j1)."""
    return _row_twiddles_host(mod, n0, n1, True, resolve_device(device))


def sixstep_row_twiddles_plain(
    mod: Modulus, n0: int, n1: int, *, inverse: bool = False, device=None
) -> MontPair:
    """Host-built inter-step twiddles in PLAIN canonical form, companion-
    free: the Solinas engine's counterpart of ``sixstep_row_twiddles``."""
    w = np.array(_row_values(mod, n0, n1, inverse), dtype=np.uint64).reshape(n0, n1)
    return MontPair(from_numpy(w, resolve_device(device)), None)


def montgomery_scalar(mod: Modulus, value: int, device=None) -> MontPair:
    """A single field constant as a broadcastable Montgomery (w, wp) pair."""
    return _mont_pair(mod, [value % mod.modulus], resolve_device(device))


def sixstep_row_twiddles_device(
    mod: Modulus, n0: int, n1: int, *, inverse: bool = False,
    with_companion: bool = True, modmul: str = "montgomery",
    transposed: bool = False, columns: tuple[int, int] | None = None, device=None,
) -> MontPair:
    """Device-built inter-step twiddle matrix for large transforms.

    Same values as ``sixstep_row_twiddles[_inverse]``.  The host computes
    only the n0 row bases ``omega_n^(+-bitrev(p0))``; the device doubles
    the table log2(n1) times, W[:, k + 2^i] = W[:, k] * base^(2^i) for
    k < 2^i, with the canonical multiply of the engine -- the same
    canonical values the JAX package's scan recurrence emits, in log2(n1)
    vector steps instead of n1.  ``modmul="montgomery"`` (Shoup too):
    Montgomery-form values and the optional companion; ``"solinas"``:
    plain canonical values from ``solinas_mul``, always companion-free.
    ``transposed=True`` returns the (n1, n0) matrix W^T, the layout the
    lead-orientation kernel consumes.  ``columns=(start, count)`` builds
    only the columns [start, start + count) of W, starting the doubling
    from ``base^start``: the block a distributed shard holds, without the
    whole matrix ever being on its device.
    """
    start, count = columns or (0, n1)
    if count & (count - 1) or count < 1 or not 0 <= start <= n1 - count:
        raise ValueError(f"columns {columns} must be a power-of-two block of [0, {n1})")
    device = resolve_device(device)
    N = mod.modulus
    omega = mod.get_root_forward(n0 * n1)
    if inverse:
        omega = mod.invert(omega)
    perm = bitreverse_permutation(n0)
    solinas = modmul == "solinas"
    fc = FieldConsts.from_modulus(mod, lazy=False, modmul="solinas" if solinas else "montgomery")
    mul = fc.solinas_mul if solinas else fc.mont_mul_full
    lift = (lambda v: v) if solinas else mod.to_montgomery
    bases = np.array([lift(pow(omega, p, N)) for p in perm], dtype=np.uint64)
    step = from_numpy(bases, device)  # base^(2^i), in the engine's form
    firsts = np.array([lift(pow(omega, p * start, N)) for p in perm], dtype=np.uint64)
    wt = from_numpy(firsts, device)[None, :]
    while wt.shape[0] < count:
        wt = torch.cat([wt, mul(wt, step[None, :])], dim=0)
        step = mul(step, step)
    w = wt if transposed else wt.t().contiguous()
    wp = w * s64(mod.montgomery_inverse) if with_companion and not solinas else None
    return MontPair(w, wp)


def limb_columns(mods, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, N^-1 mod 2^64, R = 2^64 mod N) of each limb's Modulus in ``mods``,
    as (L,) int64 tensors on ``device``."""
    def col(values):
        return from_numpy(np.array(values, dtype=np.uint64), device)

    return (col([m.modulus for m in mods]), col([m.montgomery_inverse for m in mods]),
            col([m.montgomery_r for m in mods]))


def limb_doubling(first, step, count: int, n, ninv) -> torch.Tensor:
    """first * step^k for k < ``count`` (a power of two) along a new last
    axis, in Montgomery form: the table doubled log2(count) times,
    w[..., k + 2^i] = w[..., k] * step^(2^i), as
    ``sixstep_row_twiddles_device`` doubles it.  ``first`` and ``step`` are
    Montgomery-form tensors of one shape whose leading axis is the limb;
    ``n`` / ``ninv`` broadcast against them."""
    n, ninv = n.unsqueeze(-1), ninv.unsqueeze(-1)
    w, step = first.unsqueeze(-1), step.unsqueeze(-1)
    while w.shape[-1] < count:
        w = torch.cat([w, mont_mul_by(w, step, n, ninv)], dim=-1)
        step = mont_mul_by(step, step, n, ninv)
    return w


def sixstep_row_twiddles_limbs(
    mods, n0: int, n1: int, *, inverse: bool = False, with_companion: bool = True, device=None,
) -> MontPair:
    """The inter-step twiddle matrices of L limbs at once, (L, n0, n1):
    limb l's is ``sixstep_row_twiddles[_inverse](mods[l], n0, n1)`` (the
    Montgomery form; ``with_companion=False`` drops the companion), bit
    for bit.  Built on ``device`` in vectorized steps for all limbs, as
    ``sixstep_row_twiddles_device`` builds one modulus's: the rows' bases
    omega^bitrev(p0) from a doubled table of omega's powers, then each row
    doubled log2(n1) times."""
    device = resolve_device(device)
    n, ninv, r = limb_columns(mods, device)
    omegas = []
    for mod in mods:
        w = mod.get_root_forward(n0 * n1)
        omegas.append(mod.to_montgomery(mod.invert(w) if inverse else w))
    omega = from_numpy(np.array(omegas, dtype=np.uint64), device)
    powers = limb_doubling(r, omega, n0, n, ninv)  # (L, n0)
    perm = torch.as_tensor(np.asarray(bitreverse_permutation(n0)), device=device)
    bases = powers[:, perm]
    nb, nib = n[:, None], ninv[:, None]
    w = limb_doubling(r[:, None].expand_as(bases), bases, n1, nb, nib)
    wp = w * ninv[:, None, None] if with_companion else None
    return MontPair(w, wp)


@dataclass(frozen=True)
class ForwardTables:
    """Per-stage DIF twiddles of a length-m NTT: ``stages[s]`` covers
    half-width ``l = m >> (s+1)`` and holds the ``l`` twiddles
    ``omega_{2l}^j`` with their companions."""

    m: int
    stages: tuple[MontPair, ...]


@dataclass(frozen=True)
class InverseTables:
    """Per-stage DIT twiddles: ``stages[s]`` covers ``l = 1 << s`` with
    ``omegainv_{2l}^j``; the last stage holds ``s * omegainv_m^j`` and
    ``scale`` the pair of ``s = m^-1 * scale_extra``."""

    m: int
    stages: tuple[MontPair, ...]
    scale: MontPair


def forward_tables(
    mod: Modulus, m: int, modmul: str = "montgomery", device=None
) -> ForwardTables:
    """DIF stage tables (stage order l = m/2 ... 1)."""
    if m & (m - 1) or m < 2:
        raise ValueError("m must be a power of two >= 2")
    device = resolve_device(device)
    N = mod.modulus
    omega_2l = mod.get_root_forward(m)
    stages = []
    for i in range(m.bit_length() - 2, -1, -1):
        stages.append(_twiddle_pair(mod, _powers(omega_2l, 1 << i, N), modmul, device))
        omega_2l = omega_2l * omega_2l % N
    return ForwardTables(m, tuple(stages))


def inverse_tables(
    mod: Modulus, m: int, scale_extra: int = 1, modmul: str = "montgomery", device=None
) -> InverseTables:
    """DIT stage tables (stage order l = 1 ... m/2) with 1/m (times
    ``scale_extra``) folded into the last stage."""
    if m & (m - 1) or m < 2:
        raise ValueError("m must be a power of two >= 2")
    device = resolve_device(device)
    N = mod.modulus
    log2m = m.bit_length() - 1
    omegainv_m = mod.invert(mod.get_root_forward(m))
    s = mod.invert(m) * (scale_extra % N) % N
    stages = []
    for i in range(log2m):
        tw = _powers(pow(omegainv_m, 1 << (log2m - i - 1), N), 1 << i, N)
        if i == log2m - 1:
            tw = [t * s % N for t in tw]  # fold the scaling into the last stage
        stages.append(_twiddle_pair(mod, tw, modmul, device))
    return InverseTables(m, tuple(stages), _twiddle_pair(mod, [s], modmul, device))
