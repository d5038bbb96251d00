"""The matrix NTT: small-m NTTs as int8 plane matrix products.

The PyTorch counterpart of ``sventt_tpu/ops/ntt_mxu.py``.  A length-m NTT
(m <= MAX_MXU) is the product with the bit-reversed, Montgomery-lifted DFT
matrix

  forward:  X[p] = sum_j  M[p, j] * x[j],   M[p, j] = R64 * omega^(bitrev(p)*j)
  inverse:  x[k] = sum_p  Mi[k, p] * y[p],  Mi[k, p] = R64 * s * omega^(-k*bitrev(p))

(s = m^-1 * scale_extra, R64 = 2^64 mod N), cut into int8 planes by one of
three schemes (``make_mxu_tables(scheme=...)``), as in the JAX package:

* ``"s8"`` (the default, the one every plan uses): each matrix entry is
  lifted to its minimal residue and cut into eight balanced base-256
  digits d_a in [-128, 127]; each data word into eight offset bytes
  s_b = byte_b - 128.  The 64 (a, b) products give 15 int32 planes
  P_t = sum_{a+b=t}, each biased non-negative by exactly m << 17 (the
  worst-case |P_t|); the per-row constant ``corr`` absorbs every byte
  offset and plane bias.  Planes (8m, m).
* ``"s8b"``: the same digits stacked into the block-banded (15m, 8m)
  matrix G, block (t, b) holding digit plane t - b, so that one product
  with the stacked (8m, B) bytes yields the 15 planes directly.  Same
  ``corr``; the results are bitwise those of s8.  m <= 512.
* ``"u7"``: ten unsigned 7-bit planes of the entry and of the data word;
  the 100 plane products give 19 unsigned planes at bit 7t, each below
  2^27.4 at m = 1024.  No bias and no ``corr``.  Planes (10m, m).

The planes recombine into a 192-bit value, the top word folds via
2^128 mod N, a Barrett step or conditional subtracts bring the high word
below N, and a Montgomery REDC (whose R^-1 cancels R64) lands in canonical
[0, N).

The int8 tensor-core kernel (``csrc/mxu_tc.cuh``) replaces the Pallas
kernels ``sventt_tpu/ops/ntt_mxu.py::_mxu_call`` (body ``_mxu_body``) in
both of its orientations and ``_mxu_lane_call``:

* lead (``mxu_ntt``, K1): the transform runs along axis 0 of (m, B);
* mid (``mxu_ntt_mid``, K2): along axis 1 of (A, m, B);
* lane (``mxu_ntt_lane``, K3): along the last axis of (B, m).  JAX's
  lane kernel takes no twiddle; the port's takes one in the data's own
  layout, which makes it the six-step root's row step without the two
  transposes of JAX's (``sventt_tpu/plan/planner.py:563-574``).

Each is one kernel over an (A, m, B) view with strides: the lane
orientation is the view (1, m, B) of the (B, m) rows with transform stride
1 and batch stride m, read in place.  ``kernel_for`` names the kernel a
call runs: every scheme runs on the int8 tensor cores in every
orientation, s8 and s8b as ``csrc/ntt_mxu_tc.cu``'s instantiations, u7 as
``csrc/ntt_mxu_tc_u7.cu``'s, with the launch geometry of ``tc_geometry``.
An optional inter-step twiddle multiply is fused in: before the plane
split on the forward, after the REDC on the inverse.

On a CPU tensor the wrappers run ``_mxu_plain``, the same algorithm in plain
PyTorch; on a CUDA tensor they launch the kernel or raise.  ``LAUNCHES``
counts kernel launches and ``PLAIN_CALLS`` plain-version calls, per
orientation; ``KERNEL_LAUNCHES`` counts the launches per kernel and
``LIMBS`` the limbs they carried.

The port's own limb axis: ``MxuLimbs`` stacks the s8 tables of L moduli
(a multi-modular configuration, one modulus a limb), built for all limbs
at once by ``make_mxu_limb_tables``.  The same three wrappers take it with
data whose leading axis is the limb, (L, ...), and launch the kernel once
for every limb (``csrc/ntt_mxu_tc_limbs.cu``): the limbs' slices make up
the (A, m, B) view's A, and a slice reads its limb's planes, corr and
constants (``field.limb.LimbConsts.table``) by the limb's index.  On a CPU
tensor the plain version runs limb by limb.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..field.golden import bitreverse_permutation
from ..field.limb import (
    FieldConsts,
    LimbConsts,
    _shr,
    add_mod,
    from_numpy,
    mont_mul_by,
    s64,
    u64_add_carry,
    u64_lt,
    u64_mulhi,
    u64_select,
)
from ..field.limb import reduce_consts as _reduce_consts
from ..field.modulus import MASK32, Modulus
from ..utils.device import resolve_device, sm_count
from ..utils.profiling import span
from . import ntt_pallas
from .twiddle import MontPair, check_companion, inter_step_mul, montpair_map

#: Seven-bit planes per u64 for the "u7" scheme (10 * 7 = 70 >= 64 bits).
NL = 10

#: Balanced-digit planes: 8 signed base-256 matrix digits x 8 data bytes.
NL_S8 = 8

#: The plane schemes.
SCHEMES = ("s8", "u7", "s8b")

#: Largest matrix-NTT length (the s8 int32 bound 8 * m * 2^14 < 2^31 holds
#: to 2048, the u7 bound 10 * m * 127^2 < 2^31 to 1024; the JAX package caps
#: at 1024 and so does the port).
MAX_MXU = 1024

_K8 = (1 << 64) // 255  # 0x0101010101010101
#: Largest value of 8 balanced base-256 digits: 127 * K8.
C8_PLUS = 127 * _K8

#: Kernel launches per orientation (added to where the kernel launches).
LAUNCHES = {"lead": 0, "mid": 0, "lane": 0}
#: Plain-version calls per orientation.
PLAIN_CALLS = {"lead": 0, "mid": 0, "lane": 0}
#: Kernel launches per kernel: "tensor_core" csrc/mxu_tc.cuh (K11's
#: launches too).
KERNEL_LAUNCHES = {"tensor_core": 0}
#: Limbs carried per kernel, summed over its launches: 1 a single-modulus
#: launch, L a launch on ``MxuLimbs`` (every limb in one launch).
LIMBS = {"tensor_core": 0}
#: The host span of each kernel's launch (``utils.profiling.span``).
LAUNCH_SPANS = {k: f"sventt.launch.{k}" for k in KERNEL_LAUNCHES}


def _balanced8(r: int) -> list[int]:
    """Exact balanced base-256 digits of r in [-128*K8, C8_PLUS]."""
    ds = []
    for _ in range(8):
        b = ((r + 128) & 0xFF) - 128
        ds.append(b)
        r = (r - b) >> 8
    assert r == 0, "residue outside the 8-digit balanced range"
    return ds


@dataclass(frozen=True)
class MxuDirection:
    """Prepared tables for one direction at one length, on one device.

    ``planes``: int8 ``_mat_dims(scheme, m)``: for s8 (8m, m), digit plane a
    of row p at row a*m + p; for u7 (10m, m), 7-bit plane a likewise; for
    s8b the banded (15m, 8m) matrix.  ``corr``: (m,) int64, the
    per-output-row offset correction (mod N) of s8 and s8b, None for u7.
    ``c128`` / ``nprime``: 2^128 mod N and N^-1 mod 2^64.
    ``kernel_planes`` (derived, not a field): the planes the kernels read,
    ``planes`` itself, or for s8b G's first block column -- block (a, 0)
    is digit plane a, so that column is the s8 stack and s8b runs the s8
    kernels.  ``tc_planes`` (derived, tables on a CUDA device, else None):
    those planes in the tensor-core kernel's ring-tile layout,
    ``tc_plane_tiles``, for blocks of ``tc_nt`` columns: every call on the
    tables launches with that block.  None (the default) is
    ``tc_columns``' rule; another width is the geometry A/B point that
    ``chip_smoke.py`` times (``dataclasses.replace(t, tc_nt=...)``).
    """

    m: int
    inverse: bool
    planes: torch.Tensor
    corr: torch.Tensor | None
    modulus: int
    c128: int
    nprime: int
    scheme: str = "s8"
    tc_nt: int | None = None

    def __post_init__(self):
        kp = self.planes
        if self.scheme == "s8b":
            kp = kp[: NL_S8 * self.m, : self.m].contiguous()
        object.__setattr__(self, "kernel_planes", kp)
        tiles = None
        if kp.is_cuda:
            tiles = tc_plane_tiles(kp, self.m, self.scheme, self.tc_nt)
        object.__setattr__(self, "tc_planes", tiles)


def _mat_dims(scheme: str, m: int) -> tuple[int, int]:
    """(rows, cols) of the stacked matrix operand for one scheme."""
    if scheme == "s8b":
        return 15 * m, NL_S8 * m
    if scheme == "s8":
        return NL_S8 * m, m
    return NL * m, m


def _lifted_matrix(N: int, g: int, m: int, inverse: bool, scale_extra: int) -> np.ndarray:
    """The bit-reversed, Montgomery-lifted DFT matrix, (m, m) exact Python
    ints in [0, N), of every scheme."""
    mod = Modulus(N, g)
    perm = bitreverse_permutation(m)
    r64 = (1 << 64) % N
    M = np.zeros((m, m), dtype=object)
    if not inverse:
        omega = mod.get_root_forward(m)
        for p in range(m):
            base = pow(omega, perm[p], N)
            v = r64
            for j in range(m):
                M[p, j] = v
                v = v * base % N
    else:
        # Mi[k, p] = omega^(-k*bitrev(p)) * s * R64, walked down each column
        omegainv = mod.invert(mod.get_root_forward(m))
        s = mod.invert(m) * (scale_extra % N) % N * r64 % N
        for p in range(m):
            base = pow(omegainv, perm[p], N)
            v = s
            for k in range(m):
                M[k, p] = v
                v = v * base % N
    return M


@functools.lru_cache(maxsize=None)
def _host_tables(
    N: int, g: int, m: int, inverse: bool, scale_extra: int, scheme: str
) -> tuple[np.ndarray, np.ndarray | None]:
    """(planes int8 ``_mat_dims(scheme, m)``, corr uint64 (m,) or None for
    u7) built with exact Python ints."""
    M = _lifted_matrix(N, g, m, inverse, scale_extra)
    if scheme == "u7":
        planes = np.concatenate(
            [((M >> (7 * i)) & 0x7F).astype(np.int8) for i in range(NL)], axis=0
        )
        return planes, None
    R = np.where(M <= C8_PLUS, M, M - N)  # minimal residues, |r| <= 128*K8
    # digit 0 in exact object arithmetic (R reaches just past int64 min);
    # the quotient then fits int64 and the rest is vectorized
    d0 = ((R + 128) % 256) - 128
    digs = [d0.astype(np.int8)]
    r = np.array([[int(v) for v in row] for row in (R - d0) // 256], dtype=np.int64)
    for _ in range(1, NL_S8):
        d = ((r + 128) & 0xFF) - 128
        digs.append(d.astype(np.int8))
        r = (r - d) >> 8
    assert not r.any(), "residue outside the 8-digit balanced range"
    if scheme == "s8b":
        # block (t, b) of the banded (15m, 8m) matrix holds digit plane t - b
        planes = np.zeros(_mat_dims(scheme, m), dtype=np.int8)
        for t in range(15):
            for b in range(max(0, t - NL_S8 + 1), min(t, NL_S8 - 1) + 1):
                planes[t * m:(t + 1) * m, b * m:(b + 1) * m] = digs[t - b]
    else:
        planes = np.concatenate(digs, axis=0)
    # the per-plane bias m << 17 must equal the kernel's (csrc/mxu_tail.cuh)
    # and _mxu_plain's: it is the exact worst-case |P_t|
    ofs_total = (m << 17) * sum(1 << (8 * t) for t in range(15))
    rowsums = R.sum(axis=1)
    corr = np.array(
        [(128 * _K8 * int(v) - ofs_total) % N for v in rowsums], dtype=np.uint64
    )
    return planes, corr


def make_mxu_tables(
    mod: Modulus, m: int, *, inverse: bool, scale_extra: int = 1, scheme: str = "s8",
    device=None,
) -> MxuDirection:
    """The plane matrix and row corrections of one scheme for one direction.

    The host build is cached per (modulus, m, inverse, scale_extra, scheme);
    it loops over m^2 Python ints, seconds at m = 1024.  ``device`` None is
    the CUDA card.
    """
    device = resolve_device(device)
    if m < 2 or m & (m - 1) or m > MAX_MXU:
        raise ValueError(f"mxu engine supports power-of-two m in [2, {MAX_MXU}]")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown mxu plane scheme {scheme!r}")
    if scheme == "s8b" and m > 512:
        # as in the JAX package, whose banded matrix (120 m^2 bytes) must fit VMEM
        raise ValueError("scheme 's8b' supports m <= 512")
    N = mod.modulus
    planes, corr = _host_tables(N, mod.generator, m, inverse, scale_extra, scheme)
    return MxuDirection(
        m, inverse,
        torch.from_numpy(planes).to(device),
        None if corr is None else from_numpy(corr, device),
        N, pow(2, 128, N), pow(N, -1, 1 << 64), scheme,
    )


@dataclass(frozen=True)
class MxuLimbs:
    """The s8 tables of L limbs (a multi-modular configuration, one
    modulus a limb) for one direction at one length, stacked on one
    device: limb l's are those of ``make_mxu_tables(Modulus(moduli[l], g),
    m, inverse=...)``, bit for bit (``limb``).

    ``planes``: int8 (L, 8m, m), limb l's digit stack at ``planes[l]``;
    ``corr``: int64 (L, m).  ``tc_planes`` (derived, tables on a CUDA
    device, else None): every limb's planes in the ring-tile layout,
    (L, ``tc_plane_tile_bytes(m)``), limb l's tiles at row l.  One kernel
    launch carries every limb: it reads a limb's planes, corr and
    constants (``LimbConsts.table``) by the limb's index.
    """

    m: int
    inverse: bool
    planes: torch.Tensor
    corr: torch.Tensor
    moduli: tuple[int, ...]
    scheme = "s8"
    tc_nt = None

    def __post_init__(self):
        tiles = None
        if self.planes.is_cuda:
            tiles = tc_plane_tiles(self.planes, self.m).reshape(len(self.moduli), -1)
        object.__setattr__(self, "tc_planes", tiles)

    def limb(self, i: int) -> MxuDirection:
        """Limb ``i``'s tables as a single-modulus ``MxuDirection`` (views of
        the stacked ones)."""
        N = self.moduli[i]
        return MxuDirection(self.m, self.inverse, self.planes[i], self.corr[i], N,
                            pow(2, 128, N), pow(N, -1, 1 << 64))


def make_mxu_limb_tables(mods, m: int, *, inverse: bool, device=None) -> MxuLimbs:
    """The s8 tables of every limb in ``mods`` (Modulus objects) at length
    m, built for all limbs at once in vectorized int64 steps on ``device``
    (None: the CUDA card), equal to ``make_mxu_tables`` limb for limb.

    The lifted matrix is a gather from the powers of each limb's omega
    (M[p, j] = R64 * omega^(bitrev(p) * j mod m); the inverse's entries
    s * R64 * omega^(-k * bitrev(p) mod m)), the powers doubled in
    Montgomery form; the balanced digits of a minimal residue r are the
    bytes of r + 128 * K8 less 128; ``corr`` is each row's sum mod N (a
    tree of modular adds) times 128 * K8, less the planes' bias, mod N.
    """
    from .twiddle import limb_columns, limb_doubling

    device = resolve_device(device)
    if m < 2 or m & (m - 1) or m > MAX_MXU:
        raise ValueError(f"mxu engine supports power-of-two m in [2, {MAX_MXU}]")
    L = len(mods)
    n, ninv, r = limb_columns(mods, device)

    def col(values):
        return from_numpy(np.array(values, dtype=np.uint64), device)

    omega = col([mod.to_montgomery(mod.get_root_forward(m)) for mod in mods])
    powers = limb_doubling(r, omega, m, n, ninv)  # (L, m): R64 * omega^e
    perm = torch.as_tensor(np.asarray(bitreverse_permutation(m)), device=device)
    e = torch.arange(m, device=device)
    idx = (perm[:, None] * e[None, :]) % m  # idx[p, j] = bitrev(p) * j mod m
    n2, ninv2 = n[:, None], ninv[:, None]
    if inverse:
        # s * R64 * omega^(-e), s = m^-1, in Montgomery form
        s = col([mod.to_montgomery(mod.invert(m)) for mod in mods])[:, None]
        powers = mont_mul_by(powers[:, (m - e) % m], s, n2, ninv2)
        idx = idx.t()
    M = powers[:, idx]  # (L, m, m), canonical
    n3 = n[:, None, None]
    R = torch.where((M >= 0) & (M <= C8_PLUS), M, M - n3)  # minimal residues, wrapping
    U = R + s64(128 * _K8)  # its balanced digits are U's bytes less 128
    planes = torch.stack([((_shr(U, 8 * a) & 0xFF) - 128).to(torch.int8)
                          for a in range(NL_S8)], dim=1).reshape(L, NL_S8 * m, m)
    rowsum = M
    while rowsum.shape[-1] > 1:
        h = rowsum.shape[-1] // 2
        rowsum = add_mod(rowsum[..., :h], rowsum[..., h:], n3)
    rowsum = rowsum[..., 0]  # (L, m): each row's sum mod N
    ofs_total = (m << 17) * sum(1 << (8 * t) for t in range(15))
    scale = col([mod.to_montgomery(128 * _K8 % mod.modulus) for mod in mods])[:, None]
    ofs = col([ofs_total % mod.modulus for mod in mods])[:, None]
    c = mont_mul_by(rowsum, scale, n2, ninv2)
    corr = u64_select(u64_lt(c, ofs), c - ofs + n2, c - ofs)
    return MxuLimbs(m, inverse, planes, corr, tuple(mod.modulus for mod in mods))


def _plane_products(x: torch.Tensor, t: MxuDirection) -> tuple[list, int, int]:
    """The int32-exact product planes of the scheme on (A, m, B) data, each
    (A, m, B) int64; with the bit step between planes and their bias.

    Float64 matmuls are exact here: a sum is at most m * 2^14 <= 2^24 (s8),
    8 * m * 2^14 <= 2^26 (s8b, m <= 512) or m * 127^2 < 2^24 (u7) in
    magnitude.
    """
    A, m, B = x.shape
    D = t.planes.to(torch.float64)

    def stack(planes):  # (n, A, m, B) planes -> (n*m, A*B) float64
        S = torch.stack(planes).permute(0, 2, 1, 3)
        return S.reshape(len(planes) * m, A * B).to(torch.float64)

    def split(C, n):  # (n*m, A*B) -> n (A, m, B) int64 planes
        return list(C.to(torch.int64).reshape(n, m, A, B).permute(0, 2, 1, 3))

    if t.scheme == "u7":
        xs, step, bias = [_shr(x, 7 * i) & 0x7F for i in range(NL)], 7, 0
    else:
        # offset bytes s = byte - 128 (the kernel's byte ^ 0x80 as int8)
        xs, step, bias = [(_shr(x, 8 * b) & 0xFF) - 128 for b in range(NL_S8)], 8, m << 17
        if t.scheme == "s8b":
            return split(D @ stack(xs), 15), step, bias
    out = [None] * (2 * len(xs) - 1)
    for b, xb in enumerate(xs):
        for a, C in enumerate(split(D @ stack([xb]), len(xs))):
            out[a + b] = C if out[a + b] is None else out[a + b] + C
    return out, step, bias


def _mxu_plain(
    x: torch.Tensor, t: MxuDirection, fc: FieldConsts, tw: MontPair | None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on an (A, m, B) tensor.

    ``tw``: None, or a MontPair broadcastable to (A, m, B).
    """
    m = x.shape[1]
    if tw is not None and not t.inverse:
        x = inter_step_mul(fc, x, tw)
    planes, step, bias = _plane_products(x, t)
    # 192-bit accumulate as six 32-bit words held in int64.  s8: a biased
    # plane is < 2^28, shifted by at most 24 it stays < 2^52, four per word
    # < 2^54.  u7: a plane is < 2^27.4, shifted by at most 31 < 2^58.4, five
    # per word < 2^61
    words = [torch.zeros_like(x) for _ in range(6)]
    for tt, P in enumerate(planes):
        w, sh = divmod(step * tt, 32)
        words[w] = words[w] + ((P + bias) << sh)
    if t.corr is not None:
        corr = t.corr.reshape(1, m, 1)
        words[0] = words[0] + (corr & MASK32)
        words[1] = words[1] + _shr(corr, 32)
    L, carry = [], 0
    for w in range(6):
        s = words[w] + carry
        L.append(s & MASK32)
        carry = s >> 32
    T_lo = (L[1] << 32) | L[0]
    T_hi = (L[3] << 32) | L[2]
    top = (L[5] << 32) | L[4]
    # fold: value === top*2^128 + T_hi*2^64 + T_lo (mod N); a carry out of
    # the T_hi word has weight 2^128 === c128 and folds back at weight 1
    c128 = s64(t.c128)
    T_lo2, c0 = u64_add_carry(T_lo, top * c128)
    s1, c1 = u64_add_carry(T_hi, u64_mulhi(top, torch.full_like(top, c128)))
    s2, c2 = u64_add_carry(s1, c0)
    T_lo2, c3 = u64_add_carry(T_lo2, (c1 | c2) * c128)
    T_hi = s2 + c3
    n = s64(t.modulus)
    nn = torch.full_like(T_hi, n)
    nsub, barrett = _reduce_consts(t.modulus)
    if barrett:
        mu = torch.full_like(T_hi, s64((1 << 64) // t.modulus))
        T_hi = T_hi - u64_mulhi(T_hi, mu) * n
    for _ in range(nsub):
        T_hi = u64_select(u64_lt(T_hi, nn), T_hi, T_hi - n)
    # subtractive Montgomery REDC of T_hi*2^64 + T_lo2
    qn1 = u64_mulhi(T_lo2 * s64(t.nprime), nn)
    d = T_hi - qn1
    res = u64_select(u64_lt(T_hi, qn1), d + n, d)
    res = u64_select(u64_lt(res, nn), res, res - n)
    if tw is not None and t.inverse:
        res = inter_step_mul(fc, res, tw)
    return res


def _check_cuda(t: MxuDirection, x: torch.Tensor, tw: MontPair | None):
    if t.scheme not in SCHEMES:
        raise ValueError(f"unknown mxu plane scheme {t.scheme!r}")
    if tuple(t.planes.shape) != _mat_dims(t.scheme, t.m):
        raise ValueError(f"{t.scheme} planes {tuple(t.planes.shape)} != {_mat_dims(t.scheme, t.m)}")
    if (t.corr is None) != (t.scheme == "u7"):
        raise ValueError(f"scheme {t.scheme} {'takes no' if t.scheme == 'u7' else 'needs a'} corr")
    tensors = [t.planes] + [v for v in (t.corr,) + (() if tw is None else tuple(tw)) if v is not None]
    for v in tensors:
        if v.device != x.device:
            raise ValueError(f"table on {v.device}, data on {x.device}")
    if x.dtype != torch.int64 or (t.corr is not None and t.corr.dtype != torch.int64):
        raise TypeError("data and corr must be int64")
    if t.planes.dtype != torch.int8 or not t.kernel_planes.is_contiguous():
        raise TypeError("planes must be a contiguous int8 tensor")
    if tw is not None and any(v.dtype != torch.int64 for v in tw if v is not None):
        raise TypeError("twiddles must be int64")


def _kernel_args(x: torch.Tensor, t: MxuDirection, fc: FieldConsts, tw: MontPair | None):
    """(output, the C entries' arguments before and after their own) for a
    dense (A, m, B) view (any strides; the output takes the same layout),
    after ``_check_cuda``."""
    _check_cuda(t, x, tw)
    out = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype, device=x.device)
    head = (x.data_ptr(), out.data_ptr()) + _head_args(x, t, fc, tw, t.tc_planes, t.corr)
    nsub, barrett = _reduce_consts(t.modulus)
    N = t.modulus
    tail = (N, t.nprime, t.c128, (1 << 64) // N, fc.montgomery_inverse, nsub, int(barrett))
    return out, head, tail


def _head_args(x: torch.Tensor, t, fc, tw: MontPair | None, planes: torch.Tensor, corr):
    """The C entries' arguments after the data's and the output's pointers,
    up to the lazy flag, for a dense (A, m, B) view whose output takes its
    layout: the tables' and twiddles' pointers, the shape, the data's and
    the twiddle's strides, the twiddle mode, the direction and the lazy
    flag."""
    A, m, B = x.shape
    # twiddle mode: 0 none, 1 "pair", 2 "w", 3 Solinas (plain w; the C
    # entries refuse a companion with it, as _run does)
    if tw is None:
        mode = 0
    else:
        mode = 3 if fc.modmul == "solinas" else (2 if tw.wp is None else 1)
    if tw is None:
        w_ptr = wp_ptr = None
        ts = (0, 0, 0)
    else:
        w = tw.w.expand(A, m, B)
        ts = w.stride()
        w_ptr = w.data_ptr()
        wp_ptr = None
        if tw.wp is not None:
            wp = tw.wp.expand(A, m, B)
            if wp.stride() != ts:
                raise ValueError("twiddle and companion layouts differ")
            wp_ptr = wp.data_ptr()
    return (
        planes.data_ptr(), None if corr is None else corr.data_ptr(),
        w_ptr, wp_ptr, A, m, B, *x.stride(), *ts, mode, int(t.inverse), int(fc.lazy),
    )


@dataclass(frozen=True)
class TcGeometry:
    """The tensor-core kernel's launch geometry (csrc/mxu_tc.cuh).

    ``nt`` batch columns a block; ``kp`` the transform length padded to the
    mma depth of 32; ``rs`` the data-plane row stride in shared memory
    (``kp`` + 16: ldmatrix reads 8 rows in 8 bank groups); ``rg`` rows a row
    group (the 8 warps tile it 16 rows x 8 columns); ``split`` the row
    groups' split across blocks (gridDim.z); ``smem`` the dynamic shared
    memory: the data planes of the block's columns (8 of them, u7 10), a
    3-stage ring of the matrix planes' (rg, 32) tiles and, for the staged
    lane epilogue, ``rg`` + 2 words a column.  The grid is (ceil(B / nt),
    min(A, 65535), split).
    """

    nt: int
    kp: int
    rs: int
    rg: int
    split: int
    smem: int


#: The tensor-core kernel's constants (csrc/mxu_tc.cuh).
TC_WARPS, TC_WARP_COLS, TC_KSTEP, TC_STAGES = 8, 8, 32, 3

#: A block's shared memory on sm_90 (the C entries refuse more).
TC_MAX_SMEM = 232448


def _tc_format(scheme: str) -> str:
    """The tensor-core kernel's plane format of a scheme: s8b runs s8's."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown mxu plane scheme {scheme!r}")
    return "u7" if scheme == "u7" else "s8"


def tc_block_columns(scheme: str) -> tuple[int, ...]:
    """The block widths the tensor-core kernel is built for under a
    scheme: s8's digit stack takes any multiple of 8 that tiles the 8
    warps (a kernel argument), u7 16 and 32 only (a template constant)."""
    return (16, 32) if _tc_format(scheme) == "u7" else (8, 16, 32, 64)


def tc_columns(m: int, scheme: str = "s8") -> int:
    """Batch columns a block of the tensor-core kernel takes by rule at
    length m: s8 (and s8b) 32 at m <= 512, 16 above; u7 32 at m <= 128, 16
    above (``tc_geometry`` says why)."""
    return 32 if m <= (128 if _tc_format(scheme) == "u7" else 512) else 16


#: The tensor-core kernel's forms, in the order of its template flag LANE:
#: any strided (A, m, B) view; the lane layout, stores from the mma
#: fragment; the lane layout, the row group staged in shared memory and
#: written a column's rows at a time (built for the inverse with the pair
#: twiddle only).  ``tc_form`` picks one.
TC_FORMS = ("strided", "lane", "lane_staged")


def tc_form(orientation: str, inverse: bool, tw: MontPair | None, scheme: str = "s8") -> str:
    """The tensor-core form of a call: "strided" for lead and mid; for the
    lane orientation the staged epilogue where the inverse fuses the pair
    twiddle there (its 16-byte twiddle loads; faster at the 2^24 and 2^26
    roots under s8, PERF.md section 6), else the stores from the fragment
    (faster on the forward; the staged form spills in the other modes and
    is not built for them, nor for u7)."""
    if orientation != "lane":
        return "strided"
    staged = _tc_format(scheme) == "s8" and inverse and tw is not None and tw.wp is not None
    return "lane_staged" if staged else "lane"


def tc_geometry(
    m: int, B: int, A: int = 1, sms: int = 132, form: str = "strided", scheme: str = "s8",
    nt: int | None = None, limbs: bool = False,
) -> TcGeometry:
    """Launch geometry of the tensor-core kernel for an (A, m, B) call of a
    plane scheme on a card of ``sms`` SMs: ``nt`` columns a block (one of
    ``tc_block_columns``; a block over ``TC_MAX_SMEM`` raises), by default
    ``tc_columns``' rule (s8: 32 at m <= 512, 16 above: the byte planes
    under 135 KB; two
    blocks share an SM at m <= 256.  u7, whose 10 planes take 5/4 of s8's
    shared memory: 32 at m <= 128 (K11's 76,800 bytes), 16 above, so that
    two blocks still share an SM at m = 256 (104,960 bytes; 32 columns
    there take 117,760, one block an SM, PERF.md section 6); u7 has no
    staged lane epilogue); where the grid has fewer than two
    blocks an SM, the row groups are split across up to that many blocks
    (each splits the same columns into planes and writes its own rows).  A
    lane form (A = 1) takes the (B, m) rows as its B columns: the 2^17
    root (256 rows of 512) splits its row groups, the 2^24 and 2^26 roots
    (65536 x 256, 131072 x 512) fill the card without.  ``limbs``: a call
    of stacked limbs (``MxuLimbs``), whose A slices are the limbs' (a lane
    form's A the limbs, one slice each) and count toward the grid."""
    if not 2 <= m <= MAX_MXU:
        raise ValueError(f"tensor-core kernel takes 2 <= m <= {MAX_MXU}, got {m}")
    fmt = _tc_format(scheme)
    lane_a = A != 1 and not limbs
    if (form not in TC_FORMS or (form != "strided" and lane_a)
            or (form, fmt) == ("lane_staged", "u7")):
        raise ValueError(f"tensor-core kernel form {form!r} with A = {A} under {scheme!r}")
    npl = NL if fmt == "u7" else NL_S8
    if nt is None:
        nt = tc_columns(m, scheme)
    elif nt not in tc_block_columns(scheme):
        raise ValueError(f"tensor-core kernel under {scheme!r} takes blocks of "
                         f"{tc_block_columns(scheme)} columns, got {nt}")
    kp = -(-m // TC_KSTEP) * TC_KSTEP
    rs = kp + 16
    rg = 16 * (TC_WARPS // (nt // TC_WARP_COLS))
    smem = npl * nt * rs + TC_STAGES * npl * rg * TC_KSTEP
    if form == "lane_staged":
        smem += 8 * nt * (rg + 2)
    if smem > TC_MAX_SMEM:
        raise ValueError(f"tensor-core block of {nt} columns at m = {m} takes {smem} bytes")
    n_rg = -(-m // rg)
    blocks = -(-B // nt) * A
    split = 1 if blocks >= 2 * sms else min(n_rg, -(-2 * sms // blocks))
    split = -(-n_rg // -(-n_rg // split))  # no block without a row group
    return TcGeometry(nt, kp, rs, rg, split, smem)


def tc_plane_tiles(
    planes: torch.Tensor, m: int, scheme: str = "s8", nt: int | None = None
) -> torch.Tensor:
    """The matrix planes of a scheme's kernel (the s8 digit stack (8m, m),
    the u7 planes (10m, m)) in the tensor-core kernel's ring-tile layout:
    one contiguous tile of (planes, rg rows, 32 points) per (row group,
    32-point step), in that order, rg that of ``tc_geometry(m, 1,
    scheme=scheme, nt=nt)`` (the rows of a block of ``nt`` columns, by
    default the rule's), zero past m, each 32-byte row's two 16-byte halves
    swapped in rows 4-7 of every 8 (the kernel's ``a_slot`` swizzle,
    against ldmatrix bank conflicts).  int8, flat; stacked planes (L,
    rows, m) of L limbs give each limb's tiles in turn."""
    g = tc_geometry(m, 1, scheme=scheme, nt=nt)
    npl = NL if _tc_format(scheme) == "u7" else NL_S8
    n_rg = -(-m // g.rg)
    lead = tuple(planes.shape[:-2])
    k = len(lead)
    D = torch.zeros(lead + (npl, n_rg * g.rg, g.kp), dtype=torch.int8, device=planes.device)
    D[..., :m, :m] = planes.reshape(lead + (npl, m, m))
    # (plane, row group, row, step, half, 16) -> (row group, step, plane, row, half, 16)
    T = D.reshape(lead + (npl, n_rg, g.rg, g.kp // TC_KSTEP, 2, 16))
    T = T.permute(*range(k), k + 1, k + 3, k, k + 2, k + 4, k + 5)
    swap = ((torch.arange(g.rg, device=planes.device) >> 2) & 1).bool()
    T = torch.where(swap.reshape((1,) * (k + 3) + (g.rg, 1, 1)), T.flip(k + 4), T)
    return T.contiguous().reshape(-1)


def tc_plane_tile_bytes(m: int, scheme: str = "s8") -> int:
    """Bytes of ``tc_plane_tiles(planes, m, scheme)`` without building it:
    the matrix planes (8, u7 10), m rounded up to whole row groups, times
    ``kp``."""
    g = tc_geometry(m, 1, scheme=scheme)
    return (NL if _tc_format(scheme) == "u7" else NL_S8) * -(-m // g.rg) * g.rg * g.kp


def _aligned16(v: torch.Tensor) -> torch.Tensor:
    """``v``, or a copy of it where its data is not 16-byte aligned (a view
    at an odd word offset): the lane forms read and write 16 bytes at a
    time."""
    return v if v.data_ptr() % 16 == 0 else v.clone(memory_format=torch.preserve_format)


def _launch_tc(
    x: torch.Tensor, t: MxuDirection, fc: FieldConsts, tw: MontPair | None,
    form: str = "strided",
) -> torch.Tensor:
    """Launch the int8 tensor-core kernel (csrc/mxu_tc.cuh: the s8 entry
    of csrc/ntt_mxu_tc.cu for s8 / s8b tables, the u7 entry of
    csrc/ntt_mxu_tc_u7.cu for u7 ones) on a dense (A, m, B) view in one of
    ``TC_FORMS`` (a lane form takes the (1, m, B) view of contiguous
    rows); raise on any error."""
    from .. import _build

    if t.tc_planes is None:
        raise ValueError("the tensor-core kernel takes tables built on a CUDA device")
    if form != "strided":
        # the transposed view of contiguous rows keeps its strides
        x = _aligned16(x[0].t()).t().unsqueeze(0)
        if tw is not None:
            tw = montpair_map(lambda v: _aligned16(v[0].t()).t().unsqueeze(0), tw)
    out, head, tail = _kernel_args(x, t, fc, tw)
    A, m, B = x.shape
    geo = tc_geometry(m, B, A, sm_count(x.device.index), form, t.scheme, t.tc_nt)
    lib = _build.load()
    entry = lib.sventt_mxu_ntt_tc_u7 if t.scheme == "u7" else lib.sventt_mxu_ntt_tc
    rc = entry(
        *head, *tail, TC_FORMS.index(form), geo.nt, geo.split, geo.smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mxu tensor-core kernel launch failed: CUDA error {rc}")
    return out


def kernel_for(scheme: str, orientation: str) -> str:
    """The kernel a CUDA call runs, a ``KERNEL_LAUNCHES`` key:
    "tensor_core" for every scheme in every orientation (K11, the u7 lead
    form, included)."""
    if scheme not in SCHEMES or orientation not in LAUNCHES:
        raise ValueError(f"unknown mxu scheme / orientation {scheme!r} / {orientation!r}")
    return "tensor_core"


def _launch_kernel(x3: torch.Tensor, t: MxuDirection, fc: FieldConsts, tw3, orientation: str):
    """Launch the kernel ``kernel_for`` names on the (A, m, B) view of a
    CUDA call in ``tc_form``'s form, and count it under
    ``KERNEL_LAUNCHES``."""
    kernel = kernel_for(t.scheme, orientation)
    with span(LAUNCH_SPANS[kernel]):
        out = _launch_tc(x3, t, fc, tw3, tc_form(orientation, t.inverse, tw3, t.scheme))
    KERNEL_LAUNCHES[kernel] += 1
    LIMBS[kernel] += 1
    return out


def _as3(x: torch.Tensor, tw: MontPair | None, m: int, orientation: str):
    """(A, m, B) view of the data, the twiddles broadcastable to it, and
    a function taking the (A, m, B) result back to the data's shape:
    lead (m, batch...) -> (1, m, B) with tw (1, m, B); mid (A, m, batch...)
    -> (A, m, B) with tw (A, m, 1); lane (batch..., m) -> the (1, m, B)
    view of the contiguous (B, m) rows, transform stride 1, with tw in the
    data's own layout viewed the same way."""
    if orientation == "lane":
        if x.shape[-1] != m:
            raise ValueError(f"trailing axis {x.shape[-1]} != transform length {m}")
        shape = tuple(x.shape)

        def view(v):
            return v.reshape(-1, m).contiguous().t().unsqueeze(0)

        if tw is not None:
            if tuple(tw.w.shape) != shape:
                raise ValueError(f"lane twiddle {tuple(tw.w.shape)} != data {shape}")
            tw = montpair_map(view, tw)
        return view(x), tw, lambda y: y[0].t().reshape(shape)
    mid = orientation == "mid"
    if mid:
        if x.dim() < 2 or x.shape[1] != m:
            raise ValueError(f"axis-1 length != transform length {m}")
        a, batch_shape = x.shape[0], tuple(x.shape[2:])
    else:
        if x.shape[0] != m:
            raise ValueError(f"leading axis {x.shape[0]} != transform length {m}")
        a, batch_shape = 1, tuple(x.shape[1:])
    b = int(np.prod(batch_shape)) if batch_shape else 1
    if tw is not None:
        shape = (a, m, 1) if mid else (1, m, b)
        tw = montpair_map(lambda v: v.reshape(shape), tw)
    out_shape = ((a, m) if mid else (m,)) + batch_shape
    return x.reshape(a, m, b).contiguous(), tw, lambda y: y.reshape(out_shape)


def _as3_limbs(x: torch.Tensor, tw: MontPair | None, m: int, orientation: str, L: int):
    """``_as3`` of stacked limbs' data, limb l at ``x[l]``: the (L * a, m, B)
    view whose slices [l * a, (l + 1) * a) are limb l's, the twiddles (limb
    l's at ``tw[l]``) in the same form, a, and the way back.  Lead (L, m,
    batch...) -> (L, m, B); mid (L, A, m, batch...) -> (L * A, m, B) with tw
    (L * A, m, 1); lane (L, batch..., m) -> the (L, m, B) view of each
    limb's contiguous (B, m) rows, one slice a limb."""
    if x.dim() < 2 or x.shape[0] != L:
        raise ValueError(f"leading axis of {tuple(x.shape)} != the tables' {L} limbs")
    if orientation == "lane":
        if x.shape[-1] != m:
            raise ValueError(f"trailing axis {x.shape[-1]} != transform length {m}")
        shape = tuple(x.shape)

        def view(v):
            return v.reshape(L, -1, m).contiguous().transpose(1, 2)

        if tw is not None:
            if tuple(tw.w.shape) != shape:
                raise ValueError(f"lane twiddle {tuple(tw.w.shape)} != data {shape}")
            tw = montpair_map(view, tw)
        return view(x), tw, 1, lambda y: y.transpose(1, 2).reshape(shape)
    mid = orientation == "mid"
    if mid:
        if x.dim() < 3 or x.shape[2] != m:
            raise ValueError(f"axis-2 length != transform length {m}")
        a, batch_shape = x.shape[1], tuple(x.shape[3:])
    else:
        if x.shape[1] != m:
            raise ValueError(f"axis-1 length {x.shape[1]} != transform length {m}")
        a, batch_shape = 1, tuple(x.shape[2:])
    b = int(np.prod(batch_shape)) if batch_shape else 1
    if tw is not None:
        shape = (L * a, m, 1) if mid else (L, m, b)
        tw = montpair_map(lambda v: v.reshape(shape), tw)
    out_shape = (L,) + ((a, m) if mid else (m,)) + batch_shape
    return x.reshape(L * a, m, b).contiguous(), tw, a, lambda y: y.reshape(out_shape)


def _check_limbs(t: "MxuLimbs", fc: LimbConsts, x: torch.Tensor, tw: MontPair | None):
    L, m = len(t.moduli), t.m
    if not isinstance(fc, LimbConsts) or fc.moduli != t.moduli:
        raise ValueError("stacked limb tables take the LimbConsts of their own moduli")
    if tuple(t.planes.shape) != (L, NL_S8 * m, m) or tuple(t.corr.shape) != (L, m):
        raise ValueError(f"limb planes {tuple(t.planes.shape)} / corr {tuple(t.corr.shape)} "
                         f"!= {(L, NL_S8 * m, m)} / {(L, m)}")
    tensors = [t.planes, t.corr] + ([] if tw is None else [v for v in tw if v is not None])
    for v in tensors:
        if v.device != x.device:
            raise ValueError(f"table on {v.device}, data on {x.device}")
    if x.dtype != torch.int64 or t.corr.dtype != torch.int64 or t.planes.dtype != torch.int8:
        raise TypeError("data and corr must be int64, planes int8")
    if tw is not None and any(v.dtype != torch.int64 for v in tw if v is not None):
        raise TypeError("twiddles must be int64")


@dataclass(frozen=True)
class TcLimbLaunch:
    """One launch of the tensor-core kernel's limb instantiations, all but
    its data worked out (``prepare_tc_limbs``), for an ``ntt_pallas``
    ``LaunchProgram`` to replay.  ``args``: the C entry's arguments from
    the planes' pointer to the shared memory (tables, twiddles, dims,
    strides, modes, the limbs' constants, form and geometry); ``shape``:
    the dense block its input and output fill, flat; ``orientation``: the
    ``LAUNCHES`` key it counts under; ``limbs``: the limbs it carries;
    ``tensors``: what ``args`` points into, held while the launch is."""

    args: tuple
    shape: tuple[int, ...]
    orientation: str
    limbs: int
    tensors: tuple = field(repr=False, compare=False)

    #: The span a launch runs in.
    span = LAUNCH_SPANS["tensor_core"]

    def call(self, src: int, out: int, stream: int) -> None:
        """The C call on input ``src`` and output ``out`` on ``stream``;
        counted."""
        from .. import _build

        rc = _build.load().sventt_mxu_ntt_tc_limbs(src, out, *self.args, stream)
        if rc != 0:
            raise RuntimeError(f"mxu tensor-core limb kernel launch failed: CUDA error {rc}")
        KERNEL_LAUNCHES["tensor_core"] += 1
        LIMBS["tensor_core"] += self.limbs
        LAUNCHES[self.orientation] += 1


def prepare_tc_limbs(
    x: torch.Tensor, t: "MxuLimbs", fc: LimbConsts, tw: MontPair | None, form: str, apl: int,
    orientation: str,
) -> TcLimbLaunch:
    """The launch of ``_launch_tc_limbs`` on the dense (L * apl, m, B) view
    ``x`` (16-byte aligned in a lane form), checked and prepared; it reads
    nothing of ``x`` but its device, shape and strides."""
    if t.tc_planes is None:
        raise ValueError("the tensor-core kernel takes tables built on a CUDA device")
    _check_limbs(t, fc, x, tw)
    A, m, B = x.shape
    geo = tc_geometry(m, B, A, sm_count(x.device.index), form, limbs=True)
    consts = fc.table(x.device)
    args = _head_args(x, t, fc, tw, t.tc_planes, t.corr) + (
        consts.data_ptr(), apl, t.tc_planes.shape[1], TC_FORMS.index(form), geo.nt,
        geo.split, geo.smem,
    )
    tensors = (t.tc_planes, t.corr, consts) + (() if tw is None else tuple(tw))
    return TcLimbLaunch(args, (x.numel(),), orientation, len(t.moduli), tensors)


def _launch_tc_limbs(
    x: torch.Tensor, t: "MxuLimbs", fc: LimbConsts, tw: MontPair | None, form: str, apl: int,
    orientation: str,
) -> torch.Tensor:
    """Launch the tensor-core kernel's limb instantiations
    (csrc/ntt_mxu_tc_limbs.cu) once on the (L * apl, m, B) view of every
    limb's data: slice a reads limb a // apl's planes, corr and constants
    (``LimbConsts.table``); counted under ``orientation``, recorded for a
    ``LaunchProgram``; raise on any error."""
    if form != "strided":
        # each limb's rows stay contiguous; the lane forms read 16 bytes at a time
        x = _aligned16(x.transpose(1, 2)).transpose(1, 2)
        if tw is not None:
            tw = montpair_map(lambda v: _aligned16(v.transpose(1, 2)).transpose(1, 2), tw)
    launch = prepare_tc_limbs(x, t, fc, tw, form, apl, orientation)
    out = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype, device=x.device)
    launch.call(x.data_ptr(), out.data_ptr(), ntt_pallas.current_stream(x.device))
    dense = (x.transpose(1, 2) if form != "strided" else x).is_contiguous()
    ntt_pallas.record_launch(launch, x.data_ptr(), out.data_ptr(), dense)
    return out


def _plain_limbs(x3, t: "MxuLimbs", fc: LimbConsts, tw3, apl: int) -> torch.Tensor:
    """``_mxu_plain`` limb by limb on the (L * apl, m, B) view, each limb's
    slices with its own tables and constants."""
    def part(v, i):
        return v[i * apl:(i + 1) * apl]

    return torch.cat([
        _mxu_plain(part(x3, i), t.limb(i), fc[i],
                   None if tw3 is None else montpair_map(lambda v: part(v, i), tw3))
        for i in range(len(t.moduli))
    ])


def _run_limbs(x, t: "MxuLimbs", fc: LimbConsts, tw, orientation: str):
    """``_run`` on stacked limbs: one launch for every limb on a CUDA
    tensor, the plain version limb by limb on a CPU one."""
    L = len(t.moduli)
    x3, tw3, apl, back = _as3_limbs(x, tw, t.m, orientation, L)
    if x.is_cuda:
        kernel = "tensor_core"
        form = tc_form(orientation, t.inverse, tw3)
        if form == "lane_staged" and fc.lazy:
            form = "lane"  # the staged epilogue's lazy limb instantiation is not built
        with span(LAUNCH_SPANS[kernel]):
            out = _launch_tc_limbs(x3, t, fc, tw3, form, apl, orientation)
        return back(out)
    if x.device.type != "cpu":
        raise ValueError(f"mxu engine runs on cpu or cuda tensors, got {x.device}")
    _check_limbs(t, fc, x, tw)
    PLAIN_CALLS[orientation] += 1
    return back(_plain_limbs(x3, t, fc, tw3, apl))


def _run(x, t: MxuDirection, fc: FieldConsts, tw, orientation: str):
    check_companion(fc, tw)
    if isinstance(t, MxuLimbs):
        return _run_limbs(x, t, fc, tw, orientation)
    x3, tw3, back = _as3(x, tw, t.m, orientation)
    if x.is_cuda:
        out = _launch_kernel(x3, t, fc, tw3, orientation)
        LAUNCHES[orientation] += 1
        return back(out)
    if x.device.type != "cpu":
        raise ValueError(f"mxu engine runs on cpu or cuda tensors, got {x.device}")
    PLAIN_CALLS[orientation] += 1
    return back(_mxu_plain(x3, t, fc, tw3))


def mxu_ntt(
    x: torch.Tensor, tables: MxuDirection, fc: FieldConsts, tw: MontPair | None = None
) -> torch.Tensor:
    """Length-m matrix NTT along the leading axis of (m, batch...).

    ``tw``: optional inter-step MontPair in the SAME (m, batch...) layout as
    the data, fused as prologue (forward) / epilogue (inverse).  Output is
    canonical, or lazy [0, 2N) representatives when a lazy-mode epilogue is
    fused.
    """
    return _run(x, tables, fc, tw, "lead")


def mxu_ntt_mid(
    x: torch.Tensor, tables: MxuDirection, fc: FieldConsts, tw: MontPair | None = None
) -> torch.Tensor:
    """Length-m matrix NTT along axis 1 of (A, m, batch...).

    ``tw``: optional (A, m) inter-step MontPair, broadcast over the batch
    axes and fused as prologue (forward) / epilogue (inverse).
    """
    return _run(x, tables, fc, tw, "mid")


def mxu_ntt_lane(
    x: torch.Tensor, tables: MxuDirection, fc: FieldConsts, tw: MontPair | None = None
) -> torch.Tensor:
    """Length-m matrix NTT along the LAST axis of (batch..., m): the
    six-step row step on the natural layout, without transposes.

    ``tw``: optional inter-step MontPair in the SAME (batch..., m) layout as
    the data (a level's (m0, m1) table), fused as prologue (forward) /
    epilogue (inverse).  JAX's lane kernel takes none; with it the call
    equals JAX's root step, a transpose, ``mxu_ntt`` with the transposed
    table and a transpose back, bit for bit.
    """
    return _run(x, tables, fc, tw, "lane")


def mxu_plain(
    x: torch.Tensor, tables: MxuDirection, fc: FieldConsts,
    tw: MontPair | None = None, mid: bool = False, lane: bool = False,
) -> torch.Tensor:
    """The plain version of ``mxu_ntt`` (default), ``mxu_ntt_mid``
    (``mid=True``) or ``mxu_ntt_lane`` (``lane=True``) on a tensor on any
    device, stacked limbs' (``MxuLimbs``) limb by limb; counts nothing.
    The reference a kernel is held against on the card."""
    orientation = "lane" if lane else ("mid" if mid else "lead")
    if isinstance(tables, MxuLimbs):
        x3, tw3, apl, back = _as3_limbs(x, tw, tables.m, orientation, len(tables.moduli))
        return back(_plain_limbs(x3, tables, fc, tw3, apl))
    x3, tw3, back = _as3(x, tw, tables.m, orientation)
    return back(_mxu_plain(x3, tables, fc, tw3))


def _launch_lane_form(
    x: torch.Tensor, tables: MxuDirection, fc: FieldConsts, form: str,
    tw: MontPair | None = None,
) -> torch.Tensor:
    """``mxu_ntt_lane`` on the tensor cores in the lane form ``form``,
    whichever ``tc_form`` picks: "lane" or "lane_staged" (an inverse with
    the pair twiddle only), the A/B point of the two epilogues that
    ``chip_smoke.py`` times.  CUDA tensors only; counted under
    ``KERNEL_LAUNCHES["tensor_core"]`` alone."""
    if form == "strided" or not x.is_cuda:
        raise ValueError("the lane-form A/B point takes a lane form and a CUDA tensor")
    check_companion(fc, tw)
    x3, tw3, back = _as3(x, tw, tables.m, "lane")
    with span(LAUNCH_SPANS["tensor_core"]):
        out = _launch_tc(x3, tables, fc, tw3, form)
    KERNEL_LAUNCHES["tensor_core"] += 1
    LIMBS["tensor_core"] += 1
    return back(out)


def reset_counts() -> None:
    """Set every launch, plain-call and limb count to zero."""
    for d in (LAUNCHES, PLAIN_CALLS, KERNEL_LAUNCHES, LIMBS):
        for k in d:
            d[k] = 0


# ctypes signatures of the C entries in csrc/ntt_mxu_tc.cu /
# csrc/ntt_mxu_tc_u7.cu (with the form, nt, split and the shared memory)
_HEAD = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int] * 3
)
_TAIL = [ctypes.c_ulonglong] * 5 + [ctypes.c_int] * 2
_TC_ARGTYPES = _HEAD + _TAIL + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
# csrc/ntt_mxu_tc_limbs.cu: the per-limb constants' table, slices a limb and
# a limb's tile bytes in place of the tail
_TC_LIMB_ARGTYPES = (_HEAD + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                     + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
