"""64-bit modular arithmetic on ``torch.int64`` tensors holding u64 bit patterns.

The PyTorch counterpart of ``sventt_tpu/field/limb.py``.  The TPU has no
64-bit multiply, so the JAX package carries every element as a (hi, lo) pair
of uint32 limbs; the GPU multiplies 64-bit words natively, so here an element
is ONE ``int64`` tensor holding the u64 bit pattern.  PyTorch's ``uint64``
has no add, sub, shift or compare, so the plain versions below work on
``int64`` with these rules:

* add, sub and the low 64 bits of a multiply wrap, exactly as u64 does;
* ``>>`` is arithmetic, so a logical shift masks after shifting (``_shr``);
* an unsigned compare flips the sign bit of both sides first (``u64_lt``);
* ``hi64(a*b)`` is assembled from 32-bit halves (``u64_mulhi``), as
  ``sventt_tpu.field.limb`` assembles it from 16-bit halves.

The same functions exist as CUDA device code in ``csrc/field.cuh``, where
``__umul64hi`` gives ``hi64`` in one instruction.  The (hi, lo) limb pair
exists only at the test boundary (``from_limbs`` / ``to_limbs``).

The Montgomery, Shoup and Solinas engines, the lazy and canonical add/sub
and the radix-2 butterflies are ported.  ``LimbConsts`` holds the
constants of a multi-modular (RNS) configuration, one modulus a limb, and
``mont_mul_by`` / ``add_mod`` are the canonical Montgomery product and sum
with the modulus a tensor, one a limb, for the tables built for all limbs
at once.  ``hi64(q*N)`` is the generic
product: the sparse-modulus chains of the JAX package compute the same
value with fewer 32-bit multiplies, which a GPU does not need.  The
Solinas fold multiplies the high word by ``eps`` with 64-bit products
(``u64_reduce128_sparse_high``), where the JAX package shifts a
small-constant product across limbs; every fold is exact, so both give
the same canonical result.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .modulus import MASK32, MASK64, Modulus

#: The sign bit as an int64: XOR with it maps unsigned order onto signed.
SIGN = -(1 << 63)


def s64(value: int) -> int:
    """A Python int in [0, 2^64) as the int64 with the same bit pattern."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


def u64(value: int) -> int:
    """The unsigned value of an int64 bit pattern (inverse of ``s64``)."""
    return value & MASK64


# ---------------------------------------------------------------------------
# conversions at the test and host boundary
# ---------------------------------------------------------------------------


def from_numpy(arr, device=None) -> torch.Tensor:
    """numpy uint64 (or int-like) array -> int64 tensor of the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array of the same bits."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def from_limbs(hi, lo, device=None) -> torch.Tensor:
    """(hi, lo) uint32 limb arrays (numpy) -> int64 tensor."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return from_numpy((hi << np.uint64(32)) | lo, device)


def to_limbs(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 tensor -> (hi, lo) uint32 numpy limb arrays."""
    a = to_numpy(x)
    return (a >> np.uint64(32)).astype(np.uint32), a.astype(np.uint32)


# ---------------------------------------------------------------------------
# u64 primitives on int64 tensors
# ---------------------------------------------------------------------------


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a u64 bit pattern by k in [0, 64)."""
    return x if k == 0 else (x >> k) & ((1 << (64 - k)) - 1)


def u64_lt(a, b) -> torch.Tensor:
    """Unsigned a < b."""
    return (a ^ SIGN) < (b ^ SIGN)


def u64_add(a, b) -> torch.Tensor:
    """(a + b) mod 2^64."""
    return a + b


def u64_add_carry(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(a + b) mod 2^64 and the carry-out bit (int64 0/1)."""
    s = a + b
    return s, u64_lt(s, a).to(torch.int64)


def u64_sub(a, b) -> torch.Tensor:
    """(a - b) mod 2^64."""
    return a - b


def u64_select(pred, a, b) -> torch.Tensor:
    """pred ? a : b, elementwise."""
    return torch.where(pred, a, b)


def u64_min(a, b) -> torch.Tensor:
    """Unsigned 64-bit minimum (the lazy-reduction min-trick)."""
    return u64_select(u64_lt(a, b), a, b)


def u64_mullo(a, b) -> torch.Tensor:
    """Low 64 bits of a*b (the wrapping int64 multiply)."""
    return a * b


def u64_mulhi(a, b) -> torch.Tensor:
    """High 64 bits of the unsigned 128-bit product a*b, from 32-bit halves."""
    a_lo, a_hi = a & MASK32, _shr(a, 32)
    b_lo, b_hi = b & MASK32, _shr(b, 32)
    ll = a_lo * b_lo  # each partial product is an exact u64 bit pattern
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = _shr(ll, 32) + (lh & MASK32) + (hl & MASK32)  # < 3 * 2^32
    return hh + _shr(lh, 32) + _shr(hl, 32) + _shr(mid, 32)


# ---------------------------------------------------------------------------
# sparse-modulus detection and the Solinas fold
# ---------------------------------------------------------------------------


def solinas_capable(N: int) -> bool:
    """Whether the Solinas engine supports this modulus: high form
    N = 2^64 - eps with eps = c*2^s - 1 and bit_width(c) + s <= 42, so
    that three folds converge (``u64_reduce128_sparse_high``)."""
    form, c, s = detect_sparse_modulus(N)
    return form == "high" and c.bit_length() + s <= 42


def detect_sparse_modulus(N: int, max_c_bits: int = 20):
    """(form, c, s) with form 'low' (N = c*2^s + 1), 'high'
    (N = 2^64 - c*2^s + 1) or 'generic'."""
    candidates = []
    M = N - 1
    s = (M & -M).bit_length() - 1
    c = M >> s
    if c.bit_length() <= max_c_bits:
        candidates.append(("low", c, s))
    M = ((1 << 64) - N + 1) & MASK64
    if M:
        s = (M & -M).bit_length() - 1
        c = M >> s
        if c.bit_length() <= max_c_bits:
            candidates.append(("high", c, s))
    if not candidates:
        return ("generic", 0, 0)
    return min(candidates, key=lambda t: t[1])


def _fold_eps(hi, lo, eps: int):
    """(hi, lo) -> (hi', lo') with hi'*2^64 + lo' = hi*eps + lo, exact."""
    e = torch.full_like(hi, eps)
    lo2, carry = u64_add_carry(lo, hi * e)
    return u64_mulhi(hi, e) + carry, lo2


def u64_reduce128_sparse_high(hi, lo, c: int, s: int) -> torch.Tensor:
    """(hi*2^64 + lo) mod N as a u64 representative in [0, 2^64), for
    N = 2^64 - eps, eps = c*2^s - 1 of at most 42 bits: 2^64 === eps
    folds the high word down.  After fold 1 it is <= 2^42, after fold 2
    <= 2^20, so fold 3's hi*eps < 2^62 fits one word; its carry out is one
    more 2^64 === eps, added without a new carry (the wrapped sum is below
    2^62).  ``FieldConsts.solinas_mul`` takes it to [0, N)."""
    eps = (c << s) - 1
    hi, lo = _fold_eps(hi, lo, eps)
    hi, lo = _fold_eps(hi, lo, eps)
    r, carry = u64_add_carry(lo, hi * eps)
    return r + carry * eps


# ---------------------------------------------------------------------------
# Modulus-bound engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldConsts:
    """The constants of one modulus, as Python ints (the kernels take them
    as arguments).  Same fields as ``sventt_tpu.field.limb.FieldConsts``."""

    modulus: int
    montgomery_inverse: int  # N^-1 mod 2^64
    lazy: bool  # values in [0, 2N) vs canonical [0, N)
    modmul: str = "montgomery"
    n_form: str = "generic"
    n_c: int = 0
    n_s: int = 0

    @classmethod
    def from_modulus(
        cls, mod: Modulus, lazy: bool | None = None, modmul: str = "montgomery"
    ) -> "FieldConsts":
        if lazy is None:
            lazy = mod.bit_width <= 62
        if lazy and mod.bit_width > 62:
            raise ValueError(
                "lazy [0,2N) arithmetic requires bit_width(N) <= 62; "
                f"modulus has {mod.bit_width} bits"
            )
        if modmul == "auto":
            modmul = "montgomery"
        if modmul not in ("montgomery", "shoup", "solinas"):
            raise ValueError(f"unknown modmul engine {modmul!r}")
        if modmul == "shoup" and not lazy:
            raise ValueError("shoup engine requires lazy mode (bit_width <= 62)")
        form, c, s = detect_sparse_modulus(mod.modulus)
        if modmul == "solinas" and not solinas_capable(mod.modulus):
            raise ValueError(
                "solinas engine requires a sparse-high modulus "
                "N = 2^64 - (c*2^s - 1) with bit_width(c*2^s) <= 42"
            )
        return cls(mod.modulus, mod.montgomery_inverse, lazy, modmul, form, c, s)

    # -- addition/subtraction ------------------------------------------------

    def add(self, a, b) -> torch.Tensor:
        """a + b staying in range: lazy [0, 2N) by the min-trick (needs
        4N < 2^64), canonical [0, N) with a carry-aware wrap."""
        n = s64(self.modulus)
        if self.lazy:
            s = a + b
            return u64_min(s, s - 2 * n)
        s, carry = u64_add_carry(a, b)
        take_wrapped = (carry != 0) | ~u64_lt(s, torch.full_like(s, n))
        return u64_select(take_wrapped, s - n, s)

    def sub(self, a, b) -> torch.Tensor:
        """a - b staying in range: lazy a - b + 2N then the min-trick,
        canonical +N on borrow."""
        n = s64(self.modulus)
        if self.lazy:
            d = a - b + 2 * n
            return u64_min(d, d - 2 * n)
        d = a - b
        return u64_select(u64_lt(a, b), d + n, d)

    def normalize(self, a: torch.Tensor) -> torch.Tensor:
        """Map [0, 2N) -> canonical [0, N) (identity in canonical mode)."""
        if not self.lazy:
            return a
        return u64_min(a, a - s64(self.modulus))

    def mont_mul(self, a, w, wp) -> torch.Tensor:
        """Montgomery multiply with a precomputed companion
        ``wp = w * N^-1 mod 2^64``: ``hi64(a*w) - hi64(lo64(a*wp) * N)``,
        plus N as ``_redc_finish`` decides."""
        return self._redc_finish(u64_mulhi(a, w), a * wp)

    def _redc_finish(self, ab1, q) -> torch.Tensor:
        """ab1 - hi64(q*N), +N always (lazy, (0, 2N)) or on borrow
        (canonical, [0, N))."""
        n = s64(self.modulus)
        qn1 = u64_mulhi(q, torch.full_like(q, n))
        d = ab1 - qn1
        if self.lazy:
            return d + n
        return u64_select(u64_lt(ab1, qn1), d + n, d)

    def mont_mul_full(self, a, b) -> torch.Tensor:
        """Montgomery multiply computing the companion in flight:
        ``q = lo64(a*b) * N^-1``."""
        q = (a * b) * s64(self.montgomery_inverse)
        return self._redc_finish(u64_mulhi(a, b), q)

    def shoup_mul(self, a, w, wp) -> torch.Tensor:
        """Shoup multiply: ``a*w - hi64(a*wp)*N`` in [0, 2N), with ``w``
        plain-domain and ``wp = floor(w * 2^64 / N)``."""
        if self.modulus.bit_length() > 63:
            raise ValueError("Shoup multiply requires bit_width(N) <= 63")
        n = s64(self.modulus)
        c = a * w - u64_mulhi(a, wp) * n
        if self.lazy:
            return c
        return u64_min(c, c - n)

    def solinas_mul(self, a, w) -> torch.Tensor:
        """Companion-free direct multiply: a*w mod N, canonical [0, N), for
        a PLAIN-domain ``w`` and any ``a`` < 2^64.  The 128-bit product is
        folded by ``u64_reduce128_sparse_high``; one min-subtract finishes,
        since N > 2^63.  Needs ``n_form == "high"``; a Solinas modulus has
        64 bits, so this engine is never lazy."""
        r = u64_reduce128_sparse_high(u64_mulhi(a, w), a * w, self.n_c, self.n_s)
        return u64_min(r, r - s64(self.modulus))

    # -- butterflies ---------------------------------------------------------

    def twiddle_mul(self, a, w, wp) -> torch.Tensor:
        """Multiply by a prepared stage-twiddle pair via the configured
        engine: Montgomery ``(w*R, w*R*N^-1)``, Shoup ``(w, floor(w*2^64/N))``
        or Solinas (``w`` plain canonical, ``wp`` ignored, may be None)."""
        if self.modmul == "shoup":
            return self.shoup_mul(a, w, wp)
        if self.modmul == "solinas":
            return self.solinas_mul(a, w)
        return self.mont_mul(a, w, wp)

    def butterfly_forward(self, x0, x1, w, wp):
        """DIF butterfly ``(x0 + x1, (x0 - x1) * w)``.  In lazy mode the
        difference is biased by +2N and left unreduced in (0, 4N)."""
        y0 = self.add(x0, x1)
        if self.lazy:
            d = x0 - x1 + 2 * s64(self.modulus)
        else:
            d = self.sub(x0, x1)
        return y0, self.twiddle_mul(d, w, wp)

    def butterfly_inverse(self, x0, x1, w, wp):
        """DIT butterfly: ``t = x1 * w``; ``(x0 + t, x0 - t)``."""
        t = self.twiddle_mul(x1, w, wp)
        return self.add(x0, t), self.sub(x0, t)

    def butterfly_inverse_scaled(self, x0, x1, s, sp, sw, swp):
        """Last DIT butterfly with 1/m folded in: ``a = x0*s``,
        ``b = x1*sw`` (``sw = s*w``); ``(a + b, a - b)``.  The companions
        ``sp`` / ``swp`` are None under Solinas."""
        a = self.twiddle_mul(x0, s, sp)
        b = self.twiddle_mul(x1, sw, swp)
        return self.add(a, b), self.sub(a, b)


# ---------------------------------------------------------------------------
# Multi-modular (RNS) limbs
# ---------------------------------------------------------------------------


def reduce_consts(N: int) -> tuple[int, bool]:
    """(number of conditional subtracts, whether a Barrett step precedes
    them) that bring a u64 below N: (2^64-1)//N subtracts when that is at
    most 3, else one Barrett step (error < 2N) and one subtract."""
    nsub = max(1, ((1 << 64) - 1) // N)
    if nsub > 3:
        return 1, True
    return nsub, False


def mont_mul_by(a, b, n, ninv) -> torch.Tensor:
    """The canonical Montgomery product a * b / 2^64 mod N for a, b in
    [0, N), with N and N^-1 mod 2^64 int64 tensors broadcast against them
    (one modulus a limb): ``FieldConsts.mont_mul_full`` of a canonical
    ``FieldConsts``, vectorized over moduli."""
    q = (a * b) * ninv
    ab1 = u64_mulhi(a, b)
    qn1 = u64_mulhi(q, n)
    d = ab1 - qn1
    return u64_select(u64_lt(ab1, qn1), d + n, d)


def add_mod(a, b, n) -> torch.Tensor:
    """(a + b) mod N, canonical, for a, b in [0, N) and N an int64 tensor
    broadcast against them: ``FieldConsts.add`` of a canonical one."""
    s, carry = u64_add_carry(a, b)
    return u64_select((carry != 0) | ~u64_lt(s, n), s - n, s)


#: Columns of ``LimbConsts.table``, a row a limb: N, N^-1 mod 2^64, 2^128
#: mod N, floor(2^64 / N), the subtracts and the Barrett flag of
#: ``reduce_consts``, R^2 mod N, 0.  The matrix and pointwise kernels read
#: a limb's constants from its row (csrc/mxu_tc.cuh, csrc/pointwise.cu).
LIMB_COLUMNS = ("N", "ninv", "c128", "mu", "nsub", "barrett", "r2", "pad")


@functools.lru_cache(maxsize=None)
def _limb_table(moduli: tuple[int, ...], device: torch.device) -> torch.Tensor:
    rows = []
    for N in moduli:
        nsub, barrett = reduce_consts(N)
        rows.append([N, pow(N, -1, 1 << 64), pow(2, 128, N), (1 << 64) // N, nsub,
                     int(barrett), pow(2, 128, N), 0])
    return from_numpy(np.array(rows, dtype=np.uint64), device)


@dataclass(frozen=True)
class LimbConsts:
    """The constants of a multi-modular (RNS) configuration: one
    ``FieldConsts`` a limb, limb l being row l of an (L, ...) tensor.  All
    limbs share one ``modmul`` and one ``lazy`` mode, the template flags of
    a kernel that carries every limb in one launch; ``from_moduli`` refuses
    a mix, naming the limb."""

    limbs: tuple[FieldConsts, ...]

    def __post_init__(self):
        first = self.limbs[0]
        for i, fc in enumerate(self.limbs):
            if (fc.lazy, fc.modmul) != (first.lazy, first.modmul):
                raise ValueError(
                    f"limb {i} (N = {fc.modulus:#x}) resolves to lazy={fc.lazy}, "
                    f"modmul={fc.modmul!r}, limb 0 to lazy={first.lazy}, "
                    f"modmul={first.modmul!r}: one launch runs one mode for every limb"
                )

    @classmethod
    def from_moduli(cls, mods, lazy: bool | None = None, modmul=lambda mod: "montgomery"):
        """The limbs of ``mods`` (Modulus objects); ``modmul`` maps a limb's
        Modulus to its engine.  A limb that ``FieldConsts.from_modulus``
        refuses raises with its index."""
        fcs = []
        for i, mod in enumerate(mods):
            try:
                fcs.append(FieldConsts.from_modulus(mod, lazy=lazy, modmul=modmul(mod)))
            except ValueError as e:
                raise ValueError(f"limb {i} (N = {mod.modulus:#x}): {e}") from None
        return cls(tuple(fcs))

    def __len__(self) -> int:
        return len(self.limbs)

    def __getitem__(self, i: int) -> FieldConsts:
        return self.limbs[i]

    @property
    def moduli(self) -> tuple[int, ...]:
        return tuple(fc.modulus for fc in self.limbs)

    @property
    def lazy(self) -> bool:
        return self.limbs[0].lazy

    @property
    def modmul(self) -> str:
        return self.limbs[0].modmul

    def table(self, device) -> torch.Tensor:
        """The (L, 8) int64 rows of ``LIMB_COLUMNS`` on ``device``, built once
        a device."""
        return _limb_table(self.moduli, torch.device(device))

    def normalize(self, a: torch.Tensor) -> torch.Tensor:
        """Map each limb's [0, 2N) to canonical [0, N) (identity in
        canonical mode); ``a`` is (L, ...)."""
        if not self.lazy:
            return a
        n = torch.tensor([s64(N) for N in self.moduli], dtype=torch.int64, device=a.device)
        n = n.reshape((len(self),) + (1,) * (a.dim() - 1))
        return u64_min(a, a - n)
