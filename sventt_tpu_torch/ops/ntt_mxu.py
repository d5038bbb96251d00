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

The kernel (``csrc/ntt_mxu.cu``) replaces the Pallas kernels
``sventt_tpu/ops/ntt_mxu.py::_mxu_call`` (body ``_mxu_body``) in both of
its orientations and ``_mxu_lane_call``, under every scheme:

* lead (``mxu_ntt``, K1): the transform runs along axis 0 of (m, B);
* mid (``mxu_ntt_mid``, K2): along axis 1 of (A, m, B);
* lane (``mxu_ntt_lane``, K3): along the last axis of (B, m), no twiddle.

All three are one kernel over an (A, m, B) view with strides: the lane
orientation is the view (1, m, B) of the (B, m) rows with transform stride
1 and batch stride m, read in place.  An optional inter-step twiddle
multiply is fused in: before the plane split on the forward, after the
REDC on the inverse.

On a CPU tensor the wrappers run ``_mxu_plain``, the same algorithm in plain
PyTorch; on a CUDA tensor they launch the kernel or raise.  ``LAUNCHES``
counts kernel launches and ``PLAIN_CALLS`` plain-version calls, per
orientation.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..field.golden import bitreverse_permutation
from ..field.limb import (
    FieldConsts,
    _shr,
    from_numpy,
    s64,
    u64_add_carry,
    u64_lt,
    u64_mulhi,
    u64_select,
)
from ..field.modulus import MASK32, Modulus
from ..utils.device import resolve_device
from .twiddle import MontPair, inter_step_mul, montpair_map

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
    ``kernel_planes`` (derived, not a field): the planes the kernel reads,
    ``planes`` itself, or for s8b G's first block column -- block (a, 0) is
    digit plane a, so that column is the s8 stack and s8b runs the s8
    kernel.
    """

    m: int
    inverse: bool
    planes: torch.Tensor
    corr: torch.Tensor | None
    modulus: int
    c128: int
    nprime: int
    scheme: str = "s8"

    def __post_init__(self):
        kp = self.planes
        if self.scheme == "s8b":
            kp = kp[: NL_S8 * self.m, : self.m].contiguous()
        object.__setattr__(self, "kernel_planes", kp)


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
    # the per-plane bias m << 17 must equal the kernel's (csrc/ntt_mxu.cu)
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


def _reduce_consts(N: int) -> tuple[int, bool]:
    """(number of conditional subtracts, whether a Barrett step precedes
    them) that bring a u64 below N: (2^64-1)//N subtracts when that is at
    most 3, else one Barrett step (error < 2N) and one subtract."""
    nsub = max(1, ((1 << 64) - 1) // N)
    if nsub > 3:
        return 1, True
    return nsub, False


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


def _launch(
    x: torch.Tensor, t: MxuDirection, fc: FieldConsts, tw: MontPair | None
) -> torch.Tensor:
    """Launch the CUDA kernel on a dense (A, m, B) view (any strides; the
    output takes the same layout); raise on any error."""
    from .. import _build

    _check_cuda(t, x, tw)
    lib = _build.load()
    A, m, B = x.shape
    out = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype, device=x.device)
    mode = 0 if tw is None else (2 if tw.wp is None else 1)
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
    nsub, barrett = _reduce_consts(t.modulus)
    N = t.modulus
    rc = lib.sventt_mxu_ntt(
        x.data_ptr(), out.data_ptr(), t.kernel_planes.data_ptr(),
        None if t.corr is None else t.corr.data_ptr(),
        w_ptr, wp_ptr, A, m, B, *x.stride(), *ts,
        mode, int(t.inverse), int(fc.lazy), int(t.scheme == "u7"),
        N, t.nprime, t.c128, (1 << 64) // N, fc.montgomery_inverse,
        nsub, int(barrett),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mxu kernel launch failed: CUDA error {rc}")
    return out


def _as3(x: torch.Tensor, tw: MontPair | None, m: int, orientation: str):
    """(A, m, B) view of the data, the twiddles broadcastable to it, and
    a function taking the (A, m, B) result back to the data's shape:
    lead (m, batch...) -> (1, m, B) with tw (1, m, B); mid (A, m, batch...)
    -> (A, m, B) with tw (A, m, 1); lane (batch..., m) -> the (1, m, B)
    view of the contiguous (B, m) rows, transform stride 1."""
    if orientation == "lane":
        if x.shape[-1] != m:
            raise ValueError(f"trailing axis {x.shape[-1]} != transform length {m}")
        shape = tuple(x.shape)
        rows = x.reshape(-1, m).contiguous()
        return rows.t().unsqueeze(0), None, lambda y: y[0].t().reshape(shape)
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


def _run(x, t: MxuDirection, fc: FieldConsts, tw, orientation: str):
    x3, tw3, back = _as3(x, tw, t.m, orientation)
    if x.is_cuda:
        out = _launch(x3, t, fc, tw3)
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


def mxu_ntt_lane(x: torch.Tensor, tables: MxuDirection, fc: FieldConsts) -> torch.Tensor:
    """Length-m matrix NTT along the LAST axis of (batch..., m), no twiddle:
    the six-step row step on the natural layout, without transposes."""
    return _run(x, tables, fc, None, "lane")


def mxu_plain(
    x: torch.Tensor, tables: MxuDirection, fc: FieldConsts,
    tw: MontPair | None = None, mid: bool = False, lane: bool = False,
) -> torch.Tensor:
    """The plain version of ``mxu_ntt`` (default), ``mxu_ntt_mid``
    (``mid=True``) or ``mxu_ntt_lane`` (``lane=True``) on a tensor on any
    device; counts nothing.  The reference a kernel is held against on the
    card."""
    orientation = "lane" if lane else ("mid" if mid else "lead")
    x3, tw3, back = _as3(x, tw, tables.m, orientation)
    return back(_mxu_plain(x3, tables, fc, tw3))


def reset_counts() -> None:
    """Set every launch and plain-call count to zero."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ctypes signature of the C entry in csrc/ntt_mxu.cu
_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int] * 4
    + [ctypes.c_ulonglong] * 5
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p]
)
