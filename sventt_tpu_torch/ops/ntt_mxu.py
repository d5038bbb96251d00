"""The s8 matrix NTT: small-m NTTs as int8 digit-plane matrix products.

The PyTorch counterpart of ``sventt_tpu/ops/ntt_mxu.py`` (scheme "s8").  A
length-m NTT (m <= MAX_MXU) is the product with the bit-reversed,
Montgomery-lifted DFT matrix

  forward:  X[p] = sum_j  M[p, j] * x[j],   M[p, j] = R64 * omega^(bitrev(p)*j)
  inverse:  x[k] = sum_p  Mi[k, p] * y[p],  Mi[k, p] = R64 * s * omega^(-k*bitrev(p))

(s = m^-1 * scale_extra, R64 = 2^64 mod N).  Each matrix entry is lifted to
its minimal residue and cut into eight balanced base-256 digits d_a in
[-128, 127]; each data word into eight offset bytes s_b = byte_b - 128.
The 64 (a, b) products give 15 int32 planes P_t = sum_{a+b=t}, each biased
non-negative by exactly m << 17 (the worst-case |P_t|); the planes
recombine into a 192-bit value, the top word folds via 2^128 mod N, a
Barrett step or conditional subtracts bring the high word below N, and a
Montgomery REDC (whose R^-1 cancels R64) lands in canonical [0, N).  The
per-row constant ``corr`` absorbs every byte offset and plane bias.

The kernel (``csrc/ntt_mxu.cu``) replaces the Pallas kernels
``sventt_tpu/ops/ntt_mxu.py::_mxu_call`` (body ``_mxu_body``) in both of
its orientations and ``_mxu_lane_call``:

* lead (``mxu_ntt``, K1): the transform runs along axis 0 of (m, B);
* mid (``mxu_ntt_mid``, K2): along axis 1 of (A, m, B);
* lane (``mxu_ntt_lane``, K3): along the last axis of (B, m), no twiddle.

All three are one kernel over an (A, m, B) view with strides: the lane
orientation is the view (1, m, B) of the (B, m) rows with transform stride
1 and batch stride m, read in place.  An optional inter-step twiddle
multiply is fused in: before the byte split on the forward, after the
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

#: Balanced-digit planes: 8 signed base-256 matrix digits x 8 data bytes.
NL_S8 = 8

#: Largest matrix-NTT length (the s8 int32 bound 8 * m * 2^14 < 2^31 holds
#: to 2048; the JAX package caps at 1024 and so does the port).
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

    ``planes``: (8m, m) int8, digit plane a of row p at row a*m + p.
    ``corr``: (m,) int64, the per-output-row offset correction (mod N).
    ``c128`` / ``nprime``: 2^128 mod N and N^-1 mod 2^64.
    """

    m: int
    inverse: bool
    planes: torch.Tensor
    corr: torch.Tensor
    modulus: int
    c128: int
    nprime: int


@functools.lru_cache(maxsize=None)
def _host_tables(
    N: int, g: int, m: int, inverse: bool, scale_extra: int
) -> tuple[np.ndarray, np.ndarray]:
    """(planes int8 (8m, m), corr uint64 (m,)) built with exact Python ints."""
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
    mod: Modulus, m: int, *, inverse: bool, scale_extra: int = 1, device=None
) -> MxuDirection:
    """The digit-plane matrix and row corrections for one direction.

    The host build is cached per (modulus, m, inverse, scale_extra); it
    loops over m^2 Python ints, seconds at m = 1024.  ``device`` None is
    the CUDA card.
    """
    device = resolve_device(device)
    if m < 2 or m & (m - 1) or m > MAX_MXU:
        raise ValueError(f"mxu engine supports power-of-two m in [2, {MAX_MXU}]")
    N = mod.modulus
    planes, corr = _host_tables(N, mod.generator, m, inverse, scale_extra)
    return MxuDirection(
        m, inverse,
        torch.from_numpy(planes).to(device),
        from_numpy(corr, device),
        N, pow(2, 128, N), pow(N, -1, 1 << 64),
    )


def _reduce_consts(N: int) -> tuple[int, bool]:
    """(number of conditional subtracts, whether a Barrett step precedes
    them) that bring a u64 below N: (2^64-1)//N subtracts when that is at
    most 3, else one Barrett step (error < 2N) and one subtract."""
    nsub = max(1, ((1 << 64) - 1) // N)
    if nsub > 3:
        return 1, True
    return nsub, False


def _mxu_plain(
    x: torch.Tensor, t: MxuDirection, fc: FieldConsts, tw: MontPair | None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on an (A, m, B) tensor.

    ``tw``: None, or a MontPair broadcastable to (A, m, B).  The 64 (digit,
    byte) products go through float64 matmuls, exact here: each partial sum
    is at most m * 2^14 <= 2^24 in magnitude.
    """
    A, m, B = x.shape
    if tw is not None and not t.inverse:
        x = inter_step_mul(fc, x, tw)
    D = t.planes.to(torch.float64)  # (8m, m)
    planes = [None] * 15
    for b in range(NL_S8):
        # offset byte s = byte - 128 (the kernel's byte ^ 0x80 as int8)
        s = (_shr(x, 8 * b) & 0xFF) - 128
        S = s.permute(1, 0, 2).reshape(m, A * B).to(torch.float64)
        C = (D @ S).to(torch.int64).reshape(NL_S8, m, A, B).permute(0, 2, 1, 3)
        for a in range(NL_S8):
            planes[a + b] = C[a] if planes[a + b] is None else planes[a + b] + C[a]
    # 192-bit accumulate as six 32-bit words held in int64: a biased plane is
    # < 2^28, shifted by at most 24 it stays < 2^52, four per word < 2^54
    words = [torch.zeros_like(x) for _ in range(6)]
    for tt in range(15):
        w, sh = divmod(8 * tt, 32)
        words[w] = words[w] + ((planes[tt] + (m << 17)) << sh)
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
    tensors = [t.planes, t.corr] + ([] if tw is None else [v for v in tw if v is not None])
    for v in tensors:
        if v.device != x.device:
            raise ValueError(f"table on {v.device}, data on {x.device}")
    if x.dtype != torch.int64 or t.corr.dtype != torch.int64:
        raise TypeError("data and corr must be int64")
    if t.planes.dtype != torch.int8 or not t.planes.is_contiguous():
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
        x.data_ptr(), out.data_ptr(), t.planes.data_ptr(), t.corr.data_ptr(),
        w_ptr, wp_ptr, A, m, B, *x.stride(), *ts,
        mode, int(t.inverse), int(fc.lazy),
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
    + [ctypes.c_int] * 3
    + [ctypes.c_ulonglong] * 5
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p]
)
