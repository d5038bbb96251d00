"""The plain reference: a radix-2 NTT over Z/N in plain PyTorch.

It computes its own twiddles from N and g and imports nothing but torch.
The contract it holds the program to is the one users rely on:

* ``forward`` is a decimation-in-frequency (Gentleman-Sande) transform
  without a final reordering, so its output is in bit-reversed order:
  ``forward(x)[p] == DFT(x)[bitreverse(p)]`` with the root
  ``w = g^((N-1)/n)``;
* ``inverse`` consumes bit-reversed order (decimation in time) and returns
  natural order scaled by ``1/n``;
* every value is canonical, in [0, N).

Data is an int64 tensor of u64 bit patterns, shape (n,) or (n, batch),
transformed along axis 0.  The 128-bit products are built from four
32 x 32-bit partial products in int64 arithmetic, which wraps modulo 2^64.

``arithmetic="exact"`` multiplies by Montgomery reduction with R = 2^64.
``arithmetic="float64"`` is the control: the same transform with each
modular product's quotient estimated in float64, the tempting
lower-precision step, which a 64-bit modulus does not survive.
"""

from __future__ import annotations

import torch

SIGN = -(1 << 63)
M32 = 0xFFFFFFFF


def s64(v: int) -> int:
    """The int64 bit pattern of the u64 value ``v``."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


def ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ SIGN) < (b ^ SIGN)


def mulhi(a, b):
    """High word of the unsigned 128-bit product a * b."""
    a0, a1 = a & M32, (a >> 32) & M32
    b0, b1 = b & M32, (b >> 32) & M32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = ((p00 >> 32) & M32) + (p01 & M32) + (p10 & M32)
    return p11 + ((p01 >> 32) & M32) + ((p10 >> 32) & M32) + ((mid >> 32) & M32)


class Montgomery:
    """Exact products mod an odd N < 2^64.  A multiplier constant is kept
    as w * 2^64 mod N, so ``mul(a, prep(w)) == a * w mod N``."""

    def __init__(self, modulus: int):
        self.N = modulus
        self.n64 = s64(modulus)
        self.nprime = s64(-pow(modulus, -1, 1 << 64))
        self.r2 = s64((1 << 128) % modulus)

    def prep(self, w: int) -> int:
        return s64((w << 64) % self.N)

    def mul(self, a, b):
        """a * b / 2^64 mod N, canonical, for a, b in [0, N)."""
        lo = a * b
        hi = mulhi(a, b)
        mh = mulhi(lo * self.nprime, self.n64)
        # (a*b + m*N) / 2^64 = hi + mh + carry, where the low words sum to
        # 0 or to exactly 2^64 (carry 1 iff lo != 0); the value is < 2N
        nz = lo != 0
        s = hi + mh
        carry = ult(s, hi)
        s = s + nz.to(torch.int64)
        carry = carry | (nz & (s == 0))
        return torch.where(carry | ~ult(s, self.n64), s - self.n64, s)

    def mul_plain(self, a, b):
        """a * b mod N for a, b in [0, N)."""
        return self.mul(self.mul(a, b), self.r2)


class Float64:
    """The control's products: the quotient of a * b by N estimated in
    float64.  Multiplier constants are kept as they are."""

    def __init__(self, modulus: int):
        self.N = modulus
        self.n64 = s64(modulus)

    def prep(self, w: int) -> int:
        return s64(w)

    @staticmethod
    def _f64(a):
        return a.double() + (a < 0).double() * float(1 << 64)

    def mul(self, a, b):
        a = torch.as_tensor(a, dtype=torch.int64)
        b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
        q = torch.floor(self._f64(a) * self._f64(b) / float(self.N))
        qh = torch.floor(q / float(1 << 32))
        q64 = (qh.to(torch.int64) << 32) + (q - qh * float(1 << 32)).to(torch.int64)
        r = a * b - q64 * self.n64
        return torch.where(ult(r, self.n64), r, r - self.n64)

    mul_plain = mul


def add(a, b, n64: int):
    s = a + b
    return torch.where(ult(s, a) | ~ult(s, n64), s - n64, s)


def sub(a, b, n64: int):
    d = a - b
    return torch.where(ult(a, b), d + n64, d)


class ReferenceNTT:
    """Forward and inverse transforms of length n over Z/N, on ``device``."""

    def __init__(self, modulus: int, generator: int, n: int, device, arithmetic: str = "exact"):
        if n < 2 or n & (n - 1) or (modulus - 1) % n:
            raise ValueError(f"no length-{n} transform over Z/{modulus}")
        self.n = n
        self.N = modulus
        self.f = {"exact": Montgomery, "float64": Float64}[arithmetic](modulus)
        self.device = torch.device(device)
        w = pow(generator, (modulus - 1) // n, modulus)
        if pow(w, n // 2, modulus) != modulus - 1:
            raise ValueError(f"{generator} gives no primitive {n}-th root mod {modulus}")
        self.fwd_tw = self._powers(w)
        self.inv_tw = self._powers(pow(w, -1, modulus))
        self.ninv = self.f.prep(pow(n, -1, modulus))

    def _powers(self, w: int) -> torch.Tensor:
        """w^k for k < n/2, in the multiplier form, built by doubling."""
        half = self.n // 2
        t = torch.empty(half, dtype=torch.int64, device=self.device)
        t[0] = self.f.prep(1)
        length = 1
        while length < half:
            t[length:2 * length] = self.f.mul(t[:length], self.f.prep(pow(w, length, self.N)))
            length *= 2
        return t

    def _tw(self, table: torch.Tensor, h: int) -> torch.Tensor:
        """The h twiddles w_{2h}^j of a stage, shaped to broadcast."""
        return table[:: self.n // (2 * h)][:h].view(1, h, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, n64 = self.n, self.f.n64
        y = x.reshape(n, -1)
        h = n // 2
        while h >= 1:
            v = y.view(n // (2 * h), 2, h, -1)
            u0, u1 = v[:, 0], v[:, 1]
            d = self.f.mul(sub(u0, u1, n64), self._tw(self.fwd_tw, h))
            y = torch.stack((add(u0, u1, n64), d), dim=1).reshape(n, -1)
            h //= 2
        return y.reshape(x.shape)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        n, n64 = self.n, self.f.n64
        y = self.f.mul(x.reshape(n, -1), self.ninv)
        h = 1
        while h < n:
            v = y.view(n // (2 * h), 2, h, -1)
            u0 = v[:, 0]
            u1 = self.f.mul(v[:, 1], self._tw(self.inv_tw, h))
            y = torch.stack((add(u0, u1, n64), sub(u0, u1, n64)), dim=1).reshape(n, -1)
            h *= 2
        return y.reshape(x.shape)

    def polymul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The length-n cyclic convolution of a and b."""
        return self.inverse(self.f.mul_plain(self.forward(a), self.forward(b)))


def build(config: dict, device, arithmetic: str = "exact") -> ReferenceNTT:
    """The reference of a configuration file with ``modulus``, ``generator``
    and ``n``."""
    return ReferenceNTT(config["modulus"], config["generator"], config["n"], device,
                        arithmetic=arithmetic)
