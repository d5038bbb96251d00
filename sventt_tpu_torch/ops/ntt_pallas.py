"""Radix-2 butterfly NTTs along one axis, every stage in one kernel launch.

The PyTorch counterpart of the per-stage radix-2 part of
``sventt_tpu/ops/ntt_pallas.py`` (the engine ``"pallas"`` with its default
``max_r = 1``).  Three Pallas kernels of the JAX package become ONE CUDA
kernel (``csrc/ntt_pallas.cu``) in three orientations:

* leaf (``fused_ntt``, K4 ``_group_call``): along axis 0 of (m, batch...);
* mid (``fused_ntt_mid``, K5 ``_mid_call``): along axis 1 of
  (A, m, batch...), with the six-step inter-step twiddle optionally fused
  (prologue forward, epilogue inverse; the JAX package multiplies it in a
  separate pass, ``plan/planner.py::_mont_mul_bcast``);
* lane (``fused_ntt_lane``, K6 ``_lane_call``): along the last axis of
  (batch..., m), the inter-step twiddle fused the same way.

Forward stages are DIF (l = m/2 ... 1, bit-reversed output), inverse stages
DIT (l = 1 ... m/2) with 1/m folded into the last stage.  The tables are
compact: per direction one (m-1,) vector of stage twiddles, the stage of
half-width l at [l-1, 2l-1), one of companions beside it, and the inverse
scale pair (s, sp).  The JAX package pre-broadcasts the same values to its
(8, 128) vreg tiles; ``interop`` takes them back.

Lazy-mode representatives follow each JAX kernel's own sequence: K4/K5
bias the forward difference by +2N (``FieldConsts.butterfly_forward``), K6
reduces it with ``FieldConsts.sub`` first.  Both are the same residue; the
bits differ by N on some points, and the port keeps each kernel's bits.

On a CPU tensor the wrappers run the plain PyTorch version (``*_plain``);
on a CUDA tensor they launch the kernel or raise.  ``LAUNCHES`` counts
kernel launches and ``PLAIN_CALLS`` plain-version calls per orientation.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..field.limb import FieldConsts, s64
from ..field.modulus import Modulus
from ..utils.device import resolve_device
from .twiddle import MontPair, forward_tables, inter_step_mul, inverse_tables

#: Largest leaf of this engine in an automatic plan (as in the JAX package).
MAX_FUSED = 256

#: Largest transform length one kernel launch takes (its whole tile of
#: columns sits in shared memory).
MAX_LEAF = 4096

#: Points per block tile when no knob sets it: columns (leaf, mid) or rows
#: (lane) per block = TILE_POINTS // m.  32 KB of u64, under the 48 KB that
#: needs no opt-in.
TILE_POINTS = 4096

#: Largest dynamic shared memory a Hopper block may use.
MAX_SMEM = 232448

_ROADMAP_GROUPED = "ROADMAP Queue 2, K7/K8"

#: Kernel launches per orientation (added to where the kernel launches).
LAUNCHES = {"leaf": 0, "mid": 0, "lane": 0}
#: Plain-version calls per orientation.
PLAIN_CALLS = {"leaf": 0, "mid": 0, "lane": 0}


@dataclass(frozen=True)
class _StageTables:
    """Compact stage tables for one direction at one length, on one device.

    ``stage_ls``: half-widths in run order.  ``w`` / ``wp``: (m-1,) int64,
    the stage of half-width l at [l-1, 2l-1), in the form of ``modmul``;
    on the inverse the last stage holds ``s * w``.  ``scale``: the inverse
    pair (s, sp) as Python ints, None on the forward.
    """

    m: int
    inverse: bool
    modmul: str
    stage_ls: tuple[int, ...]
    w: torch.Tensor
    wp: torch.Tensor
    scale: tuple[int, int] | None

    def stage(self, l: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.w[l - 1 : 2 * l - 1], self.wp[l - 1 : 2 * l - 1]


@dataclass(frozen=True)
class FusedDirection(_StageTables):
    """Leaf and mid tables; ``block_b`` columns per block (None: the
    default tile) and ``spc`` stages per launch (None: all in one)."""

    block_b: int | None = None
    spc: int | None = None


@dataclass(frozen=True)
class LaneDirection(_StageTables):
    """Lane tables; ``rows`` batch rows per block (None: the default)."""

    rows: int | None = None


def _check_knobs(m: int, tw_layout: str | None, **knobs) -> None:
    if m < 2 or m & (m - 1) or m > MAX_LEAF:
        raise ValueError(f"butterfly engine supports power-of-two m in [2, {MAX_LEAF}]")
    # tw_layout chooses between the JAX package's pre-broadcast table
    # layouts; compact tables have one layout, so it is only validated
    if tw_layout not in (None, "tiled", "dedup", "hybrid"):
        raise ValueError(f"unknown tw_layout {tw_layout!r}")
    for name, v in knobs.items():
        if v is not None and (v < 1 or (name != "spc" and v & (v - 1))):
            raise ValueError(f"{name} must be a positive power of two, got {v}")


def _compact(pairs, ls, m: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stage pairs (run order ``ls``) -> the two (m-1,) vectors."""
    w = torch.zeros(m - 1, dtype=torch.int64, device=device)
    wp = torch.zeros(m - 1, dtype=torch.int64, device=device)
    for pair, l in zip(pairs, ls):
        w[l - 1 : 2 * l - 1] = pair.w
        wp[l - 1 : 2 * l - 1] = pair.wp
    return w, wp


def _forward_parts(mod: Modulus, m: int, modmul: str, device):
    tabs = forward_tables(mod, m, modmul, device)
    ls = tuple(m >> (s + 1) for s in range(len(tabs.stages)))
    return (m, False, modmul, ls, *_compact(tabs.stages, ls, m, device), None)


def _inverse_parts(mod: Modulus, m: int, scale_extra: int, modmul: str, device):
    tabs = inverse_tables(mod, m, scale_extra, modmul, device)
    ls = tuple(1 << s for s in range(len(tabs.stages)))
    scale = (int(tabs.scale.w[0]) % (1 << 64), int(tabs.scale.wp[0]) % (1 << 64))
    return (m, True, modmul, ls, *_compact(tabs.stages, ls, m, device), scale)


def make_fused_forward(
    mod: Modulus, m: int, modmul: str = "montgomery", block_b: int | None = None,
    spc: int | None = None, tw_layout: str = "tiled", device=None,
) -> FusedDirection:
    _check_knobs(m, tw_layout, block_b=block_b, spc=spc)
    return FusedDirection(
        *_forward_parts(mod, m, modmul, resolve_device(device)), block_b, spc
    )


def make_fused_inverse(
    mod: Modulus, m: int, scale_extra: int = 1, modmul: str = "montgomery",
    block_b: int | None = None, spc: int | None = None, tw_layout: str = "tiled",
    device=None,
) -> FusedDirection:
    _check_knobs(m, tw_layout, block_b=block_b, spc=spc)
    return FusedDirection(
        *_inverse_parts(mod, m, scale_extra, modmul, resolve_device(device)), block_b, spc
    )


def make_lane_forward(
    mod: Modulus, m: int, modmul: str = "montgomery", rows: int | None = None, device=None
) -> LaneDirection:
    _check_knobs(m, None, rows=rows)
    return LaneDirection(*_forward_parts(mod, m, modmul, resolve_device(device)), rows)


def make_lane_inverse(
    mod: Modulus, m: int, scale_extra: int = 1, modmul: str = "montgomery",
    rows: int | None = None, device=None,
) -> LaneDirection:
    _check_knobs(m, None, rows=rows)
    return LaneDirection(
        *_inverse_parts(mod, m, scale_extra, modmul, resolve_device(device)), rows
    )


def _radix2_only(max_r: int | None, modmul: str) -> None:
    if modmul == "solinas":
        raise NotImplementedError(
            "modmul='solinas' is not ported yet (ROADMAP Queue 1 item 1)"
        )
    if max_r is not None and max_r > 1:
        raise NotImplementedError(
            f"max_r={max_r} (radix-2^R grouped stages) is not ported yet ({_ROADMAP_GROUPED})"
        )


def make_leaf_tables(
    mod: Modulus, m: int, *, inverse: bool, modmul: str = "montgomery",
    max_r: int | None = None, block_b: int | None = None, spc: int | None = None,
    tw_layout: str | None = None, device=None,
) -> FusedDirection:
    """Leaf / mid tables (per-stage radix-2); ``device`` None is the card."""
    _radix2_only(max_r, modmul)
    tw_layout = tw_layout or "tiled"
    if inverse:
        return make_fused_inverse(
            mod, m, modmul=modmul, block_b=block_b, spc=spc, tw_layout=tw_layout,
            device=device,
        )
    return make_fused_forward(
        mod, m, modmul=modmul, block_b=block_b, spc=spc, tw_layout=tw_layout,
        device=device,
    )


def make_lane_tables(
    mod: Modulus, m: int, *, inverse: bool, modmul: str = "montgomery",
    max_r: int | None = None, rows: int | None = None, device=None,
) -> LaneDirection:
    """Lane tables (per-stage radix-2); ``device`` None is the card."""
    _radix2_only(max_r, modmul)
    if inverse:
        return make_lane_inverse(mod, m, modmul=modmul, rows=rows, device=device)
    return make_lane_forward(mod, m, modmul=modmul, rows=rows, device=device)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _stages_plain(
    x: torch.Tensor, t: _StageTables, fc: FieldConsts, lane: bool,
    tw: MontPair | None = None,
) -> torch.Tensor:
    """Every stage of ``t`` along axis 1 of an (A, m, B) tensor, with the
    inter-step twiddle ``tw`` (broadcastable to it) multiplied before the
    stages on the forward and after them on the inverse.  ``lane`` follows
    K6's forward sequence (difference reduced by ``fc.sub``)."""
    A, m, B = x.shape
    if tw is not None and not t.inverse:
        x = inter_step_mul(fc, x, tw)
    last = len(t.stage_ls) - 1
    for s, l in enumerate(t.stage_ls):
        v = x.reshape(A, m // (2 * l), 2, l, B)
        x0, x1 = v[:, :, 0], v[:, :, 1]
        w, wp = (a.reshape(1, 1, l, 1) for a in t.stage(l))
        if not t.inverse:
            if lane:
                y0, y1 = fc.add(x0, x1), fc.twiddle_mul(fc.sub(x0, x1), w, wp)
            else:
                y0, y1 = fc.butterfly_forward(x0, x1, w, wp)
        elif s == last:
            sc, scp = (torch.full_like(x0, s64(c)) for c in t.scale)
            y0, y1 = fc.butterfly_inverse_scaled(x0, x1, sc, scp, w, wp)
        else:
            y0, y1 = fc.butterfly_inverse(x0, x1, w, wp)
        x = torch.stack([y0, y1], dim=2).reshape(A, m, B)
    if tw is not None and t.inverse:
        x = inter_step_mul(fc, x, tw)
    return x


# ---------------------------------------------------------------------------
# views: (A, m, B) layouts of the three orientations
# ---------------------------------------------------------------------------


def _leaf_view(x: torch.Tensor, m: int):
    if x.shape[0] != m:
        raise ValueError(f"leading axis {x.shape[0]} != transform length {m}")
    b = int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
    return x.reshape(1, m, b).contiguous()


def _mid_view(x: torch.Tensor, m: int):
    if x.dim() < 2 or x.shape[1] != m:
        raise ValueError(f"axis-1 length != transform length {m}")
    b = int(np.prod(x.shape[2:])) if x.dim() > 2 else 1
    return x.reshape(x.shape[0], m, b).contiguous()


def _lane_rows(x: torch.Tensor, m: int):
    if x.shape[-1] != m:
        raise ValueError(f"trailing axis {x.shape[-1]} != transform length {m}")
    return x.reshape(-1, m).contiguous()


def leaf_plain(x: torch.Tensor, tables: FusedDirection, fc: FieldConsts) -> torch.Tensor:
    """The plain version of ``fused_ntt`` on any device; counts nothing."""
    return _stages_plain(_leaf_view(x, tables.m), tables, fc, False).reshape(x.shape)


def mid_plain(
    x: torch.Tensor, tables: FusedDirection, fc: FieldConsts, tw: MontPair | None = None
) -> torch.Tensor:
    """The plain version of ``fused_ntt_mid``: the JAX package's separate
    inter-step multiply and the stages, in its order; counts nothing."""
    x3 = _mid_view(x, tables.m)
    tw3 = None if tw is None else _mid_tw(tw, x3)
    return _stages_plain(x3, tables, fc, False, tw3).reshape(x.shape)


def lane_plain(
    x: torch.Tensor, tables: LaneDirection, fc: FieldConsts, pre_tw: MontPair | None = None
) -> torch.Tensor:
    """The plain version of ``fused_ntt_lane``; counts nothing."""
    rows = _lane_rows(x, tables.m)
    tw3 = None if pre_tw is None else _lane_tw(pre_tw, x, rows)
    out = _stages_plain(rows.unsqueeze(2), tables, fc, True, tw3)
    return out.reshape(x.shape)


def _tw_view(tw: MontPair, shape: tuple, view: tuple) -> MontPair:
    """Inter-step twiddles of exactly ``shape`` (a transposed table of the
    same size would give wrong values silently) as contiguous ``view``s."""
    for v in tw:
        if v is not None and tuple(v.shape) != tuple(shape):
            raise ValueError(f"twiddle shape {tuple(v.shape)} != {tuple(shape)}")
    return MontPair(*(None if v is None else v.reshape(view).contiguous() for v in tw))


def _mid_tw(tw: MontPair, x3: torch.Tensor) -> MontPair:
    """(A, m) inter-step twiddles as contiguous (A, m, 1) tensors."""
    A, m, _ = x3.shape
    return _tw_view(tw, (A, m), (A, m, 1))


def _lane_tw(tw: MontPair, x: torch.Tensor, rows: torch.Tensor) -> MontPair:
    """Inter-step twiddles of the data's shape as contiguous (B, m, 1)."""
    return _tw_view(tw, x.shape, rows.shape + (1,))


# ---------------------------------------------------------------------------
# the CUDA launch
# ---------------------------------------------------------------------------


def _check_cuda(t: _StageTables, fc: FieldConsts, x: torch.Tensor, tw: MontPair | None):
    tensors = [t.w, t.wp] + ([] if tw is None else [v for v in tw if v is not None])
    for v in tensors:
        if v.device != x.device:
            raise ValueError(f"table on {v.device}, data on {x.device}")
        if v.dtype != torch.int64 or not v.is_contiguous():
            raise TypeError("tables and twiddles must be contiguous int64 tensors")
    if x.dtype != torch.int64:
        raise TypeError("data must be int64")
    if fc.modmul != t.modmul:
        raise ValueError(f"tables built for {t.modmul!r}, field engine is {fc.modmul!r}")


def _launch(
    x3: torch.Tensor, t: _StageTables, fc: FieldConsts, tw3: MontPair | None,
    lane: bool, cols: int, first: int, last: int,
) -> torch.Tensor:
    """One launch of the kernel on stages [first, last) of ``t`` along axis
    1 of the contiguous (A, m, B) tensor ``x3``; ``tw3`` the contiguous
    (A, m, 1) inter-step twiddles.  Each block takes ``cols`` batch entries.
    ``lane`` (x3 is (rows, m, 1)): K6's forward sequence, and the kernel
    sees the rows as B = rows batch entries of stride m, transform stride 1,
    so a block reads whole rows."""
    from .. import _build

    _check_cuda(t, fc, x3, tw3)
    A, m, B = x3.shape
    if lane:
        dims, strides, tw_strides = (1, m, A), (0, 1, m), (0, 1, m)
    else:
        dims, strides, tw_strides = (A, m, B), x3.stride(), (m, 1, 0)
    log2c = cols.bit_length() - 1
    if (cols + 1) * m * 8 > MAX_SMEM:
        raise ValueError(f"a tile of {cols} x {m} points exceeds shared memory")
    lib = _build.load()
    out = torch.empty_like(x3)
    w_ptr = wp_ptr = None
    mode = 0
    if tw3 is not None:
        w_ptr, mode = tw3.w.data_ptr(), 2
        if tw3.wp is not None:
            wp_ptr, mode = tw3.wp.data_ptr(), 1
    s, sp = t.scale if t.scale is not None else (0, 0)
    rc = lib.sventt_butterfly_ntt(
        x3.data_ptr(), out.data_ptr(), t.w.data_ptr(), t.wp.data_ptr(), w_ptr, wp_ptr,
        dims[0], m.bit_length() - 1, dims[2], *strides, *tw_strides,
        first, last, log2c, int(t.inverse), int(fc.modmul == "shoup"), int(fc.lazy),
        int(lane), mode, fc.modulus, fc.montgomery_inverse, s, sp,
        torch.cuda.current_stream(x3.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"butterfly kernel launch failed: CUDA error {rc}")
    return out


def _run(
    x3: torch.Tensor, t: _StageTables, fc: FieldConsts, tw3: MontPair | None,
    orientation: str, cols: int | None, spc: int | None,
) -> torch.Tensor:
    lane = orientation == "lane"
    if x3.is_cuda:
        n = len(t.stage_ls)
        step = spc or n
        cols = cols or max(1, TILE_POINTS // t.m)
        for first in range(0, n, step):
            x3 = _launch(x3, t, fc, tw3, lane, cols, first, min(first + step, n))
            LAUNCHES[orientation] += 1
        return x3
    if x3.device.type != "cpu":
        raise ValueError(f"butterfly engine runs on cpu or cuda tensors, got {x3.device}")
    PLAIN_CALLS[orientation] += 1
    return _stages_plain(x3, t, fc, lane, tw3)


def fused_ntt(x: torch.Tensor, tables: FusedDirection, fc: FieldConsts) -> torch.Tensor:
    """Length-m NTT along the leading axis of (m, batch...) (K4)."""
    out = _run(_leaf_view(x, tables.m), tables, fc, None, "leaf", tables.block_b, tables.spc)
    return out.reshape(x.shape)


def fused_ntt_mid(
    x: torch.Tensor, tables: FusedDirection, fc: FieldConsts, tw: MontPair | None = None
) -> torch.Tensor:
    """Length-m NTT along axis 1 of (A, m, batch...) (K5).

    ``tw``: optional (A, m) inter-step MontPair (Montgomery form; the
    companion may be None), broadcast over the batch and fused: multiplied
    before the stages on the forward, after them on the inverse.
    """
    x3 = _mid_view(x, tables.m)
    tw3 = None if tw is None else _mid_tw(tw, x3)
    return _run(x3, tables, fc, tw3, "mid", tables.block_b, tables.spc).reshape(x.shape)


def fused_ntt_lane(
    x: torch.Tensor, tables: LaneDirection, fc: FieldConsts, pre_tw: MontPair | None = None
) -> torch.Tensor:
    """Length-m NTT along the LAST axis of (batch..., m) (K6).

    ``pre_tw``: optional inter-step MontPair in the data's layout, fused as
    prologue (forward) / epilogue (inverse).
    """
    rows = _lane_rows(x, tables.m)
    tw3 = None if pre_tw is None else _lane_tw(pre_tw, x, rows)
    out = _run(rows.unsqueeze(2), tables, fc, tw3, "lane", tables.rows, None)
    return out.reshape(x.shape)


def reset_counts() -> None:
    """Set every launch and plain-call count to zero."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ctypes signature of the C entry in csrc/ntt_pallas.cu
_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int] * 8
    + [ctypes.c_ulonglong] * 4
    + [ctypes.c_void_p]
)
