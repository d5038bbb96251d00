"""Butterfly NTTs along one axis, every stage in one kernel launch.

The PyTorch counterpart of ``sventt_tpu/ops/ntt_pallas.py`` (the engine
``"pallas"``).  With its default ``max_r = 1`` (per-stage radix-2) three
Pallas kernels of the JAX package become two CUDA kernels in three
orientations:

* leaf (``fused_ntt``, K4 ``_group_call``): along axis 0 of (m, batch...);
* mid (``fused_ntt_mid``, K5 ``_mid_call``): along axis 1 of
  (A, m, batch...), with the six-step inter-step twiddle optionally fused
  (prologue forward, epilogue inverse; the JAX package multiplies it in a
  separate pass, ``plan/planner.py::_mont_mul_bcast``);
* lane (``fused_ntt_lane``, K6 ``_lane_call``): along the last axis of
  (batch..., m), the inter-step twiddle fused the same way.

All three run on ``csrc/ntt_radix2.cu``'s register kernel: a thread holds
2^R points of one column (leaf, mid) or one row (lane) and runs up to 4
consecutive stages on them in registers; the sets meet in shared memory
once per group of stages (``butterfly_geometry`` gives the groups and the
launch geometry).

Forward stages are DIF (l = m/2 ... 1, bit-reversed output), inverse stages
DIT (l = 1 ... m/2) with 1/m folded into the last stage.  The tables are
compact: per direction one (m-1,) vector of stage twiddles, the stage of
half-width l at [l-1, 2l-1), one of companions beside it, and the inverse
scale pair (s, sp).  The Solinas engine (``modmul="solinas"``) has plain
twiddles and no companions: ``wp`` and ``sp`` are None, half the table
bytes.  The JAX package pre-broadcasts the same values to its (8, 128)
vreg tiles (2 channels a stage under Solinas, 4 otherwise); ``interop``
takes them back.

Lazy-mode representatives follow each JAX kernel's own sequence: K4/K5
bias the forward difference by +2N (``FieldConsts.butterfly_forward``), K6
reduces it with ``FieldConsts.sub`` first.  Both are the same residue; the
bits differ by N on some points, and the port keeps each kernel's bits.

With ``max_r > 1`` the stages fold into radix-2^R groups (``GroupSpec``):
R ranks whose twiddles are scalar constants, then one multiply by the
group's combined table (forward epilogue, inverse prologue; the last
inverse group's table holds 1/m).  Two more Pallas kernels become ONE CUDA
kernel (``csrc/ntt_grouped.cu``) in two orientations:

* leaf (``fused_ntt`` on a ``GroupedDirection``, K7 ``_grouped_call``);
* lane (``fused_ntt_lane`` on a ``GroupedLaneDirection``, K8
  ``_lane_grouped_call``), the inter-step twiddle fused as for K6.

Each thread of that kernel holds one group's 2^R points of a butterfly set
in registers and runs the group's R ranks there; the sets meet in shared
memory once per group boundary (``grouped_geometry`` gives the launch
geometry).

The JAX planner never sends grouped tables to the mid orientation (its
``_mid_row`` asks for a ``FusedDirection``): a batched grouped row takes
the transpose fallback, so ``fused_ntt_mid`` rejects them.  Nor does it
build them under Solinas: a group's constants and tables are companioned
pairs, so ``make_leaf_tables`` / ``make_lane_tables`` force ``max_r = 1``
there, as in the JAX package.  The lazy bits
of K7 and K8 differ as K4's and K6's do, and in one more place: K7 skips
the table multiply where the combined exponent is 0, K8 multiplies every
point by its (then unit) table entry.

On a CPU tensor the wrappers run the plain PyTorch version (``*_plain``);
on a CUDA tensor they launch the kernel or raise.  ``LAUNCHES`` counts
kernel launches and ``PLAIN_CALLS`` plain-version calls per orientation;
``KERNEL_LAUNCHES`` which radix-2 and which grouped kernel ran,
``MODMUL`` the radix-2 launches by their stage multiply and ``TWIDDLE``
by the form of the inter-step twiddle they are given.

A radix-2 launch is two steps: ``prepare_regs`` works out everything but
the data -- geometry, table and twiddle pointers, dims, strides, modes --
as a ``RegsLaunch``, and ``call_regs`` calls the C entry with it, the
input and output pointers and the stream.  ``_launch_regs`` runs both;
a ``LaunchProgram`` (a planner walk's launches, recorded by
``recording``) keeps the prepared launches and reruns only the second
step, on new pointers (``PROGRAMS`` counts programs built and replayed).
The tensor-core kernel's limb launches (``ntt_mxu.TcLimbLaunch``) are
prepared, recorded and replayed the same way.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..field.limb import FieldConsts, from_numpy, s64
from ..field.modulus import Modulus
from ..utils.device import resolve_device, sm_count
from ..utils.profiling import span
from .twiddle import (
    MontPair,
    _twiddle_pair,
    check_companion,
    forward_tables,
    inter_step_mul,
    inverse_tables,
)

#: Largest leaf of this engine in an automatic plan (as in the JAX package).
MAX_FUSED = 256

#: Default maximum radix exponent (per-stage radix-2, as in the JAX package).
DEFAULT_MAX_RADIX = 1

#: Largest radix exponent of a group (``NttConfig.max_r`` allows 1..4).
MAX_R = 4

#: Constant entries a rank of a group may have: 2^(MAX_R - 1).
MAX_LOWS = 1 << (MAX_R - 1)

#: Largest transform length one kernel launch takes (its whole tile of
#: columns sits in shared memory).
MAX_LEAF = 4096

#: Largest dynamic shared memory a Hopper block may use.
MAX_SMEM = 232448

#: Kernel launches per orientation (added to where the kernel launches):
#: radix-2 "leaf" (K4), "mid" (K5), "lane" (K6); grouped "grouped" (K7),
#: "lane_grouped" (K8).
LAUNCHES = {"leaf": 0, "mid": 0, "lane": 0, "grouped": 0, "lane_grouped": 0}
#: Plain-version calls per orientation.
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
#: Launches per kernel: radix-2 "radix2_registers" (every K4 / K5 / K6
#: call), grouped "registers" (every K7 / K8 call).
KERNEL_LAUNCHES = {"radix2_registers": 0, "registers": 0}
#: Launch programs of eager calls: "built" (a call's recorded walk),
#: "replayed" (a call that ran one instead of the walk).
PROGRAMS = {"built": 0, "replayed": 0}
#: Radix-2 register-kernel launches (K4 / K5 / K6, walked or replayed) by
#: their stage multiply: the keys of ``_MODMUL``.
MODMUL = {"montgomery": 0, "shoup": 0, "solinas": 0}
#: Radix-2 register-kernel launches (walked or replayed) by the form of the
#: inter-step twiddle they are given: the values of ``_TWIDDLE`` -- "none",
#: a Montgomery "pair" (16 bytes an entry), a companion-free Montgomery "w"
#: (8 bytes, the companion computed in flight: the root's table from
#: ``planner.W_ONLY_THRESHOLD`` on) or a plain "solinas" one.  (With
#: ``spc`` only the range that starts a forward or ends an inverse
#: multiplies it.)
TWIDDLE = {"none": 0, "pair": 0, "w": 0, "solinas": 0}

#: The register kernel's largest block (its ``__launch_bounds__``).
GROUPED_THREADS = 256
#: Constant slots of a group in the grouped tables: MAX_R x MAX_LOWS.
GROUP_CONSTS = MAX_R * MAX_LOWS
#: Shared memory a block may take and still share an SM with two others: a
#: third of the SM's 233,472 bytes less the 1 KB the card reserves per block.
SMEM_THREE_BLOCKS = 233472 // 3 - 1024
#: Stages a group of the radix-2 register kernel (csrc/ntt_radix2.cu) may
#: have: 4 + 4 at m = 256.
RADIX2_MAX_R = 4
#: Threads the lane orientation's default tile fills: four blocks of 128
#: threads an SM, as their registers allow, ran faster than two of 256.
LANE_THREADS = 128


@dataclass(frozen=True)
class _StageTables:
    """Compact stage tables for one direction at one length, on one device.

    ``stage_ls``: half-widths in run order.  ``w`` / ``wp``: (m-1,) int64,
    the stage of half-width l at [l-1, 2l-1), in the form of ``modmul``;
    on the inverse the last stage holds ``s * w``.  ``scale``: the inverse
    pair (s, sp) as Python ints, None on the forward.  Solinas: ``wp`` and
    ``sp`` are None.
    """

    m: int
    inverse: bool
    modmul: str
    stage_ls: tuple[int, ...]
    w: torch.Tensor
    wp: torch.Tensor | None
    scale: tuple[int, int | None] | None

    def stage(self, l: int) -> tuple[torch.Tensor, torch.Tensor | None]:
        wp = None if self.wp is None else self.wp[l - 1 : 2 * l - 1]
        return self.w[l - 1 : 2 * l - 1], wp


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


def _compact(pairs, ls, m: int, device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-stage pairs (run order ``ls``) -> the two (m-1,) vectors; no
    companion vector when the pairs have none (Solinas)."""
    w = torch.zeros(m - 1, dtype=torch.int64, device=device)
    wp = None if pairs[0].wp is None else torch.zeros_like(w)
    for pair, l in zip(pairs, ls):
        w[l - 1 : 2 * l - 1] = pair.w
        if wp is not None:
            wp[l - 1 : 2 * l - 1] = pair.wp
    return w, wp


def _forward_parts(mod: Modulus, m: int, modmul: str, device):
    tabs = forward_tables(mod, m, modmul, device)
    ls = tuple(m >> (s + 1) for s in range(len(tabs.stages)))
    return (m, False, modmul, ls, *_compact(tabs.stages, ls, m, device), None)


def _inverse_parts(mod: Modulus, m: int, scale_extra: int, modmul: str, device):
    tabs = inverse_tables(mod, m, scale_extra, modmul, device)
    ls = tuple(1 << s for s in range(len(tabs.stages)))
    s, sp = (None if v is None else int(v[0]) % (1 << 64) for v in tabs.scale)
    scale = (s, sp)
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


# ---------------------------------------------------------------------------
# radix-2^R groups: static structure (host Python ints)
#
# R consecutive stages factor into R ranks of butterflies whose twiddles are
# scalar constants -- powers of the order-2^R root theta -- and ONE combined
# table multiply per point (W^{bitrev_R(k)}), as in the JAX package.
# ---------------------------------------------------------------------------


def _bitrev(k: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (k & 1)
        k >>= 1
    return out


def _choose_groups(num_stages: int, max_r: int) -> tuple[int, ...]:
    """Greedy grouping of the stage cascade into radix-2^R bodies; a
    4-stage remainder becomes 2+2 rather than 3+1."""
    if max_r <= 1:
        return (1,) * num_stages
    out, n = [], num_stages
    while n > 0:
        if n == 4 and max_r >= 3:
            out += [2, 2]
            n = 0
        elif n >= max_r:
            out.append(max_r)
            n -= max_r
        else:
            out.append(n)
            n = 0
    return tuple(out)


def _const_pair(mod: Modulus, modmul: str, value: int) -> tuple[int, int]:
    """(w, wp) scalar ints in engine form for a constant twiddle
    (Montgomery or Shoup: a group's constants carry a companion)."""
    if modmul == "montgomery":
        w = mod.to_montgomery(value % mod.modulus)
        return w, mod.montgomery_precompute(w)
    w = value % mod.modulus
    return w, mod.shoup_precompute(w)


@dataclass(frozen=True)
class GroupSpec:
    """Static structure of one radix-2^R stage group.

    ``ls``: rank half-widths (forward: descending l, l/2, ...; inverse:
    ascending l, 2l, ...).  ``L``: sub-slice row unit (forward ls[-1],
    inverse ls[0]).  ``span``: the row period of the combined table.
    ``consts``: per rank, per ``low`` sub-slice index, the scalar constant
    twiddle as an engine-form (w, wp) int pair, or None for exponent 0.
    ``scaled``: inverse only, this group's table folds the 1/m scaling.
    """

    ls: tuple[int, ...]
    L: int
    span: int
    consts: tuple[tuple[object, ...], ...]
    scaled: bool = False

    @property
    def R(self) -> int:
        return len(self.ls)


def _forward_group_values(mod: Modulus, m: int, modmul: str, max_r: int):
    """(specs, per-group combined-table plain values of length m)."""
    N = mod.modulus
    specs, tables = [], []
    s0 = 0
    for R in _choose_groups(m.bit_length() - 1, max_r):
        l = m >> (s0 + 1)
        L = l >> (R - 1)
        span = 2 * l
        omega_2l = mod.get_root_forward(2 * l)
        theta = pow(omega_2l, L, N)
        consts = []
        for s in range(R):
            row = []
            for low in range((l >> s) // L):
                e = ((1 << s) * low) % (1 << R)
                row.append(None if e == 0 else _const_pair(mod, modmul, pow(theta, e, N)))
            consts.append(tuple(row))
        tables.append(
            [pow(omega_2l, (i % L) * _bitrev((i % span) // L, R), N) for i in range(m)]
        )
        specs.append(GroupSpec(tuple(l >> s for s in range(R)), L, span, tuple(consts)))
        s0 += R
    return tuple(specs), tables


def _inverse_group_values(mod: Modulus, m: int, modmul: str, scale_extra: int, max_r: int):
    """(specs, tables) for the DIT inverse; 1/m (x scale_extra) folded into
    the last group's combined pre-multiply table."""
    N = mod.modulus
    rs = _choose_groups(m.bit_length() - 1, max_r)
    s_scale = mod.invert(m) * (scale_extra % N) % N
    specs, tables = [], []
    s0 = 0
    for gi, R in enumerate(rs):
        l = 1 << s0
        span = (1 << R) * l
        omega_span = mod.invert(mod.get_root_forward(span))
        theta = pow(omega_span, l, N)
        last = gi == len(rs) - 1
        consts = []
        for s in range(R):
            row = []
            for low in range(1 << s):
                e = ((1 << (R - 1 - s)) * low) % (1 << R)
                row.append(None if e == 0 else _const_pair(mod, modmul, pow(theta, e, N)))
            consts.append(tuple(row))
        vals = [pow(omega_span, (i % l) * _bitrev((i % span) // l, R), N) for i in range(m)]
        if last:
            vals = [v * s_scale % N for v in vals]
        specs.append(
            GroupSpec(tuple((1 << s) * l for s in range(R)), l, span, tuple(consts), scaled=last)
        )
        tables.append(vals)
        s0 += R
    return tuple(specs), tables


# ---------------------------------------------------------------------------
# grouped tables
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _GroupedTables:
    """Grouped tables for one direction at one length, on one device.

    ``specs``: each group's ``GroupSpec``.  ``w`` / ``wp``: (groups, m)
    int64, each group's combined table in the form of ``modmul``.
    ``consts``: (groups, MAX_R, MAX_LOWS, 2) int64, the (w, wp) constant of
    group g, rank s, sub-slice ``low``; ``const_mask`` (groups, MAX_R,
    MAX_LOWS) bool is False where the spec holds None or no entry.
    """

    m: int
    inverse: bool
    modmul: str
    specs: tuple[GroupSpec, ...]
    w: torch.Tensor
    wp: torch.Tensor
    consts: torch.Tensor
    const_mask: torch.Tensor


@dataclass(frozen=True)
class GroupedDirection(_GroupedTables):
    """Leaf tables of the grouped engine (K7)."""


@dataclass(frozen=True)
class GroupedLaneDirection(_GroupedTables):
    """Lane tables of the grouped engine (K8)."""


def _const_tensors(specs, device) -> tuple[torch.Tensor, torch.Tensor]:
    consts = np.zeros((len(specs), MAX_R, MAX_LOWS, 2), dtype=np.uint64)
    mask = np.zeros((len(specs), MAX_R, MAX_LOWS), dtype=bool)
    for g, spec in enumerate(specs):
        for s, row in enumerate(spec.consts):
            for low, pair in enumerate(row):
                if pair is not None:
                    consts[g, s, low] = pair
                    mask[g, s, low] = True
    return from_numpy(consts, device), torch.from_numpy(mask).to(device)


def _grouped_parts(mod: Modulus, m: int, inverse: bool, modmul: str, max_r: int,
                   scale_extra: int, device) -> tuple:
    _check_knobs(m, None)
    if not 1 <= max_r <= MAX_R:
        raise ValueError(f"max_r must be in 1..{MAX_R}, got {max_r}")
    if modmul not in ("montgomery", "shoup"):
        raise ValueError(f"grouped tables carry companioned pairs; modmul {modmul!r} has none")
    device = resolve_device(device)
    if inverse:
        specs, tables = _inverse_group_values(mod, m, modmul, scale_extra, max_r)
    else:
        specs, tables = _forward_group_values(mod, m, modmul, max_r)
    pairs = [_twiddle_pair(mod, vals, modmul, device) for vals in tables]
    w = torch.stack([p.w for p in pairs])
    wp = torch.stack([p.wp for p in pairs])
    return (m, inverse, modmul, specs, w, wp, *_const_tensors(specs, device))


def make_grouped_forward(
    mod: Modulus, m: int, modmul: str = "montgomery", max_r: int = DEFAULT_MAX_RADIX,
    device=None,
) -> GroupedDirection:
    return GroupedDirection(*_grouped_parts(mod, m, False, modmul, max_r, 1, device))


def make_grouped_inverse(
    mod: Modulus, m: int, scale_extra: int = 1, modmul: str = "montgomery",
    max_r: int = DEFAULT_MAX_RADIX, device=None,
) -> GroupedDirection:
    return GroupedDirection(*_grouped_parts(mod, m, True, modmul, max_r, scale_extra, device))


def make_lane_grouped_forward(
    mod: Modulus, m: int, modmul: str = "montgomery", max_r: int = DEFAULT_MAX_RADIX,
    device=None,
) -> GroupedLaneDirection:
    return GroupedLaneDirection(*_grouped_parts(mod, m, False, modmul, max_r, 1, device))


def make_lane_grouped_inverse(
    mod: Modulus, m: int, scale_extra: int = 1, modmul: str = "montgomery",
    max_r: int = DEFAULT_MAX_RADIX, device=None,
) -> GroupedLaneDirection:
    return GroupedLaneDirection(
        *_grouped_parts(mod, m, True, modmul, max_r, scale_extra, device)
    )


@dataclass(frozen=True)
class GroupedGeometry:
    """The register kernel's launch geometry (csrc/ntt_grouped.cu).

    ``cols``: batch entries (leaf columns, lane rows) a block tile;
    ``tpc``: threads a batch entry, each owning butterfly sets ``q``,
    ``q + tpc``, ... of a group (leaf: lanes along the columns, thread
    ``q * cols + c``; lane: lanes along the sets, thread ``c * tpc + q``);
    ``threads`` = cols * tpc.  Shared memory, in order: the tile of
    ``tile_words`` u64 (cols x m), one more for each word of a fused
    twiddle, one span of each group's combined table as (w, wp) pairs
    (``tab_entries``), each group's GROUP_CONSTS constant pairs and its
    32-bit mask; ``smem`` their bytes.
    """

    cols: int
    tpc: int
    threads: int
    tile_words: int
    tab_entries: int
    smem: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def grouped_geometry(
    m: int, specs, B: int, lane: bool, A: int = 1, tw_words: int = 0, sms: int = 132
) -> GroupedGeometry:
    """Launch geometry of the register kernel for an (A, m, B) call of the
    groups ``specs`` with a fused twiddle of ``tw_words`` words a point (0
    none, 1 "w", 2 "pair").  ``tpc`` is at most the widest group's set
    count m / 2^R (every thread has a set in every group).  The leaf starts
    at 32 columns a tile with GROUPED_THREADS // 32 threads each; the lane
    at ``tpc`` = that set count, as many rows as fill GROUPED_THREADS.  No
    more batch entries than B has; then the tile halves while its shared
    memory exceeds SMEM_THREE_BLOCKS, and while the grid has fewer than two
    blocks an SM (leaf down to 4 columns, a 32-byte sector a point)."""
    if m < 2 or m & (m - 1) or m > MAX_LEAF:
        raise ValueError(f"grouped kernel takes power-of-two m in [2, {MAX_LEAF}], got {m}")
    if sum(spec.R for spec in specs) != m.bit_length() - 1:
        raise ValueError("the groups' ranks do not add up to log2 m")
    if tw_words not in (0, 1, 2):
        raise ValueError(f"a fused twiddle has 0, 1 or 2 words a point, not {tw_words}")
    nsets = m >> max(spec.R for spec in specs)
    tab_entries = sum(spec.span for spec in specs)
    fixed = 16 * tab_entries + len(specs) * (16 * GROUP_CONSTS + 4)

    def smem(cols: int) -> int:
        return 8 * cols * m * (1 + tw_words) + fixed

    if lane:
        tpc = min(nsets, GROUPED_THREADS)
        cols, floor = GROUPED_THREADS // tpc, 1
    else:
        cols, floor = 32, 4
        tpc = min(nsets, GROUPED_THREADS // cols)
    cols = min(cols, _pow2_at_least(B))
    while cols > 1 and (
        smem(cols) > SMEM_THREE_BLOCKS or (cols > floor and -(-B // cols) * A < 2 * sms)
    ):
        cols //= 2
        if not lane:
            tpc = min(nsets, GROUPED_THREADS // cols)
    if smem(cols) > MAX_SMEM:
        raise ValueError(f"grouped kernel at m = {m} needs {smem(cols)} bytes of shared memory")
    return GroupedGeometry(cols, tpc, cols * tpc, cols * m, tab_entries, smem(cols))


def radix2_groups(stages: int, max_r: int) -> tuple[int, ...]:
    """The radix-2 register kernel's split of ``stages`` consecutive
    stages: as few groups of at most ``max_r`` as can hold them, as even as
    possible, the larger first (8 -> 4 + 4 at max_r 4, 3 + 3 + 2 at 3)."""
    g = -(-stages // max_r)
    return tuple(stages // g + (i < stages % g) for i in range(g))


@dataclass(frozen=True)
class ButterflyGeometry:
    """The radix-2 register kernel's launch geometry (csrc/ntt_radix2.cu).

    ``ranks``: each group's stages in run order.  ``cols``: batch entries
    a block tile (leaf / mid columns, lane rows); ``threads``: its block,
    thread u owning, in each group, unit u, then u + threads, ...: leaf /
    mid unit u is (set u >> log2 cols, column u mod cols), lane unit u
    (row u >> log2(m >> R), set u mod (m >> R)).  Shared memory, in order:
    the exchange tile of ``tile_words`` u64 (cols x m; none for one group),
    entries [``tab_lo``, ``tab_lo`` + ``tab_entries``) of the stage tables,
    16 bytes an entry (8 under Solinas), and, where the range multiplies
    the inter-step twiddle, ``tw_bytes`` of it: a leaf / mid slice's row of
    m entries; a lane inverse tile's cols x m entries, staged by cp.async,
    where the row has two groups or more and they fit in a block's shared
    memory beside the tile (else, and for the lane forward, none: the
    twiddle is read straight into registers); 16 bytes an entry "pair", 8
    "w" or Solinas; ``smem`` their bytes.
    """

    ranks: tuple[int, ...]
    cols: int
    threads: int
    tile_words: int
    tab_lo: int
    tab_entries: int
    tw_bytes: int
    smem: int


@functools.lru_cache(maxsize=1024)
def butterfly_geometry(
    m: int, first: int, last: int, inverse: bool, B: int, A: int = 1,
    solinas: bool = False, tw_words: int = 0, block_b: int | None = None, sms: int = 132,
    lane: bool = False,
) -> ButterflyGeometry:
    """Launch geometry of the radix-2 register kernel for stages [first,
    last) of an (A, m, B) call with an inter-step twiddle of ``tw_words``
    words an entry (0 none, 1 "w" or Solinas, 2 "pair"): the groups
    (``radix2_groups`` at RADIX2_MAX_R); ``block_b`` batch entries a tile
    when set, else -- leaf / mid -- 32 columns or -- ``lane``, every stage
    of B rows (A = 1) -- as many rows as fill LANE_THREADS, no more
    than B has, halved while the tile exceeds SMEM_THREE_BLOCKS or the grid
    has fewer than two blocks an SM, down to 4 columns (a 32-byte sector a
    point) or 1 row; threads: cols times the widest group's set count, at
    most GROUPED_THREADS."""
    if m < 2 or m & (m - 1) or m > MAX_LEAF:
        raise ValueError(f"butterfly kernel takes power-of-two m in [2, {MAX_LEAF}], got {m}")
    if not 0 <= first < last <= m.bit_length() - 1:
        raise ValueError(f"stage range [{first}, {last}) outside a length-{m} transform")
    if lane and (first, last, A) != (0, m.bit_length() - 1, 1):
        raise ValueError("the lane orientation runs every stage of unsliced rows")
    ranks = radix2_groups(last - first, RADIX2_MAX_R)
    lmin, lmax = (1 << first, 1 << (last - 1)) if inverse else (m >> last, m >> (first + 1))
    tab_entries = 2 * lmax - lmin
    if tw_words not in (0, 1, 2):
        raise ValueError(f"an inter-step twiddle has 0, 1 or 2 words an entry, not {tw_words}")
    fused = tw_words and (last == m.bit_length() - 1 if inverse else first == 0)
    tile = len(ranks) > 1
    tab_bytes = tab_entries * (8 if solinas else 16)

    def tw_bytes(cols: int) -> int:
        if not fused:
            return 0
        if not lane:
            return 8 * tw_words * m
        staged = 8 * tw_words * cols * m
        fits = tile and 8 * cols * m + tab_bytes + staged <= MAX_SMEM
        return staged if inverse and fits else 0

    def smem(cols: int) -> int:
        return (8 * cols * m if tile else 0) + tab_bytes + tw_bytes(cols)

    sets = m >> max(ranks)
    if block_b is not None:
        cols = block_b
    else:
        cols, floor = (max(1, LANE_THREADS // sets), 1) if lane else (32, 4)
        cols = min(cols, _pow2_at_least(B))
        while cols > 1 and (
            smem(cols) > SMEM_THREE_BLOCKS or (cols > floor and -(-B // cols) * A < 2 * sms)
        ):
            cols //= 2
    if smem(cols) > MAX_SMEM:
        raise ValueError(f"a tile of {cols} x {m} points needs {smem(cols)} bytes of shared memory")
    threads = min(GROUPED_THREADS, cols * sets)
    return ButterflyGeometry(ranks, cols, threads, cols * m if tile else 0, lmin - 1,
                             tab_entries, tw_bytes(cols), smem(cols))


def make_leaf_tables(
    mod: Modulus, m: int, *, inverse: bool, modmul: str = "montgomery",
    max_r: int | None = None, block_b: int | None = None, spc: int | None = None,
    tw_layout: str | None = None, device=None,
) -> FusedDirection | GroupedDirection:
    """Leaf / mid tables: per-stage radix-2 by default, radix-2^R grouped
    with ``max_r`` > 1 (leaf only; ``block_b`` / ``spc`` / ``tw_layout``
    are then validated but, as in the JAX package, unused).  Solinas forces
    ``max_r = 1`` (the grouped tables are companioned), as in the JAX
    package.  ``device`` None is the card."""
    tw_layout = tw_layout or "tiled"
    if modmul == "solinas":
        max_r = 1
    if max_r is not None and max_r > 1:
        _check_knobs(m, tw_layout, block_b=block_b, spc=spc)
        if inverse:
            return make_grouped_inverse(mod, m, modmul=modmul, max_r=max_r, device=device)
        return make_grouped_forward(mod, m, modmul=modmul, max_r=max_r, device=device)
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
) -> LaneDirection | GroupedLaneDirection:
    """Lane tables: per-stage radix-2 by default, radix-2^R grouped with
    ``max_r`` > 1 (``rows`` then validated but unused; Solinas forces
    ``max_r = 1``); ``device`` None is the card."""
    if modmul == "solinas":
        max_r = 1
    if max_r is not None and max_r > 1:
        _check_knobs(m, None, rows=rows)
        if inverse:
            return make_lane_grouped_inverse(mod, m, modmul=modmul, max_r=max_r, device=device)
        return make_lane_grouped_forward(mod, m, modmul=modmul, max_r=max_r, device=device)
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
        w, wp = (None if a is None else a.reshape(1, 1, l, 1) for a in t.stage(l))
        if not t.inverse:
            if lane:
                y0, y1 = fc.add(x0, x1), fc.twiddle_mul(fc.sub(x0, x1), w, wp)
            else:
                y0, y1 = fc.butterfly_forward(x0, x1, w, wp)
        elif s == last:
            sc, scp = (None if c is None else torch.full_like(x0, s64(c)) for c in t.scale)
            y0, y1 = fc.butterfly_inverse_scaled(x0, x1, sc, scp, w, wp)
        else:
            y0, y1 = fc.butterfly_inverse(x0, x1, w, wp)
        x = torch.stack([y0, y1], dim=2).reshape(A, m, B)
    if tw is not None and t.inverse:
        x = inter_step_mul(fc, x, tw)
    return x


def _table_on_first(spec: GroupSpec, m: int, h: int, device) -> torch.Tensor:
    """(1, m/2h, h, 1) bool: where K7 multiplies a butterfly's first point
    by the combined table -- the combined exponent e0 of point j0 is not 0
    (bitrev of a nonzero index is nonzero)."""
    j0 = np.arange(m).reshape(m // (2 * h), 2, h)[:, 0]
    return torch.from_numpy((j0 % spec.span) // spec.L != 0).to(device).reshape(1, m // (2 * h), h, 1)


def _groups_plain(
    x: torch.Tensor, t: _GroupedTables, fc: FieldConsts, lane: bool,
    tw: MontPair | None = None,
) -> torch.Tensor:
    """Every group of ``t`` along axis 1 of an (A, m, B) tensor, ``tw`` as
    in ``_stages_plain``.  Rank s of group g pairs points j0 and j0 + h
    (h = ``spec.ls[s]``); the constant of sub-slice low = (j0 mod h) // L
    multiplies the difference (forward) or the second input (inverse); the
    combined table multiplies both outputs of the last forward rank and
    both inputs of the first inverse rank.  K7 (``lane`` False) biases a
    lazy forward difference by +2N where a constant follows and skips the
    table on a first point whose exponent is 0 (unless the group is
    scaled); K8 (``lane``) reduces every difference and multiplies every
    point."""
    A, m, B = x.shape
    two_n = 2 * s64(fc.modulus)
    if tw is not None and not t.inverse:
        x = inter_step_mul(fc, x, tw)
    for g, spec in enumerate(t.specs):
        for s, h in enumerate(spec.ls):
            v = x.reshape(A, m // (2 * h), 2, h, B)
            x0, x1 = v[:, :, 0], v[:, :, 1]
            lows = h // spec.L
            cw, cwp = (t.consts[g, s, :lows, k].repeat_interleave(spec.L).reshape(1, 1, h, 1)
                       for k in (0, 1))
            has = t.const_mask[g, s, :lows].repeat_interleave(spec.L).reshape(1, 1, h, 1)
            fused = s == (0 if t.inverse else spec.R - 1)
            if fused:
                tab = [a[g].reshape(1, m // (2 * h), 2, h, 1) for a in (t.w, t.wp)]
                (w0, w1), (wp0, wp1) = ((a[:, :, 0], a[:, :, 1]) for a in tab)
                if lane or spec.scaled:
                    first = torch.ones((), dtype=torch.bool, device=x.device)
                else:
                    first = _table_on_first(spec, m, h, x.device)
            if not t.inverse:
                y0 = fc.add(x0, x1)
                d = fc.sub(x0, x1)
                dc = (x0 - x1 + two_n) if fc.lazy and not lane else d
                d = torch.where(has, fc.twiddle_mul(dc, cw, cwp), d)
                if fused:
                    y0 = torch.where(first, fc.twiddle_mul(y0, w0, wp0), y0)
                    d = fc.twiddle_mul(d, w1, wp1)
                y1 = d
            else:
                if fused:
                    x0 = torch.where(first, fc.twiddle_mul(x0, w0, wp0), x0)
                    t1 = fc.twiddle_mul(x1, w1, wp1)
                else:
                    t1 = torch.where(has, fc.twiddle_mul(x1, cw, cwp), x1)
                y0, y1 = fc.add(x0, t1), fc.sub(x0, t1)
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


def grouped_plain(x: torch.Tensor, tables: GroupedDirection, fc: FieldConsts) -> torch.Tensor:
    """The plain version of ``fused_ntt_grouped`` (K7); counts nothing."""
    return _groups_plain(_leaf_view(x, tables.m), tables, fc, False).reshape(x.shape)


def lane_grouped_plain(
    x: torch.Tensor, tables: GroupedLaneDirection, fc: FieldConsts,
    pre_tw: MontPair | None = None,
) -> torch.Tensor:
    """The plain version of ``fused_ntt_lane`` on grouped tables (K8);
    counts nothing."""
    rows = _lane_rows(x, tables.m)
    tw3 = None if pre_tw is None else _lane_tw(pre_tw, x, rows)
    return _groups_plain(rows.unsqueeze(2), tables, fc, True, tw3).reshape(x.shape)


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


def _check_cuda(t, fc: FieldConsts, x: torch.Tensor, tw: MontPair | None):
    tensors = [v for v in (t.w, t.wp) if v is not None]
    tensors += [] if tw is None else [v for v in tw if v is not None]
    if isinstance(t, _GroupedTables):
        tensors.append(t.consts)
        if t.const_mask.device != x.device or t.const_mask.dtype != torch.bool:
            raise TypeError(f"const_mask must be a bool tensor on {x.device}")
    for v in tensors:
        if v.device != x.device:
            raise ValueError(f"table on {v.device}, data on {x.device}")
        if v.dtype != torch.int64 or not v.is_contiguous():
            raise TypeError("tables and twiddles must be contiguous int64 tensors")
    if x.dtype != torch.int64:
        raise TypeError("data must be int64")
    if fc.modmul != t.modmul:
        raise ValueError(f"tables built for {t.modmul!r}, field engine is {fc.modmul!r}")


def _view(x3: torch.Tensor, lane: bool):
    """The kernels' (A, m, B) view of the contiguous ``x3``: (dims, element
    strides, inter-step twiddle strides).  ``lane`` (x3 is (rows, m, 1)):
    the rows are B = rows batch entries of stride m, transform stride 1;
    otherwise the twiddle is (A, m, 1), broadcast over the batch."""
    A, m, B = x3.shape
    if lane:
        return (1, m, A), (0, 1, m), (0, 1, m)
    return (A, m, B), x3.stride(), (m, 1, 0)


#: The C entries' stage-multiply engines.
_MODMUL = {"montgomery": 0, "shoup": 1, "solinas": 2}


def _tw_args(tw3: MontPair | None, fc: FieldConsts) -> tuple:
    """(w pointer, wp pointer, mode) of the fused inter-step multiply: mode
    0 none, 1 "pair" (mont_mul), 2 "w" (mont_mul_full), 3 Solinas "w"
    (solinas_mul; the C entry refuses a companion with it, as _run does)."""
    if tw3 is None:
        return None, None, 0
    wp = None if tw3.wp is None else tw3.wp.data_ptr()
    mode = 3 if fc.modmul == "solinas" else (2 if wp is None else 1)
    return tw3.w.data_ptr(), wp, mode


#: The ``TWIDDLE`` key of each inter-step multiply mode of ``_tw_args``.
_TWIDDLE = ("none", "pair", "w", "solinas")


@dataclass(frozen=True)
class RegsLaunch:
    """One launch of the radix-2 register kernel, everything but its data
    worked out (``prepare_regs``).  ``args``: the C entry's arguments from
    the stage table's pointer to the scale's companion (tables, twiddles,
    dims, strides, stage range, geometry, modes, constants); ``shape``: the
    (A, m, B) shape of its input and output; ``orientation``: the
    ``LAUNCHES`` key it counts under (None: none, a direct launch);
    ``modmul``: the ``MODMUL`` key it counts under, its stage multiply;
    ``twiddle``: the ``TWIDDLE`` key, its inter-step twiddle's form;
    ``tensors``: what ``args`` points into, held while the launch is."""

    args: tuple
    shape: tuple[int, ...]
    orientation: str | None
    modmul: str
    twiddle: str
    tensors: tuple = field(repr=False, compare=False)

    #: The span a launch runs in.
    span = "sventt.launch.radix2_registers"

    def call(self, src: int, out: int, stream: int) -> None:
        call_regs(self, src, out, stream)


def prepare_regs(
    x3: torch.Tensor, t: FusedDirection | LaneDirection, fc: FieldConsts,
    tw3: MontPair | None, first: int, last: int, lane: bool = False,
    orientation: str | None = None,
) -> RegsLaunch:
    """The launch of stages [first, last) of ``t`` along axis 1 of the (A,
    m, B) tensor ``x3`` (see ``_launch_regs``), checked and prepared; it
    reads nothing of ``x3`` but its device, shape and strides."""
    _check_cuda(t, fc, x3, tw3)
    m = t.m
    (A, _, B), strides, (ta, tm, tb) = _view(x3, lane)
    if lane:
        ta = tb  # the twiddle's row stride: the data's layout
    w_ptr, wp_ptr, mode = _tw_args(tw3, fc)
    tw_words = 0 if tw3 is None else (1 if wp_ptr is None else 2)
    geo = butterfly_geometry(m, first, last, t.inverse, B, A, fc.modmul == "solinas", tw_words,
                             t.rows if lane else t.block_b, sm_count(x3.device.index), lane)
    ranks = sum(R << (4 * g) for g, R in enumerate(geo.ranks))
    s, sp = t.scale if t.scale is not None else (0, 0)
    args = (
        t.w.data_ptr(), None if t.wp is None else t.wp.data_ptr(), w_ptr, wp_ptr,
        A, m.bit_length() - 1, B, *strides, ta, tm, first, last, ranks,
        geo.cols.bit_length() - 1, geo.threads, geo.smem, int(t.inverse), int(lane),
        _MODMUL[fc.modmul], int(fc.lazy), mode, fc.modulus, fc.montgomery_inverse, s, sp or 0,
    )
    tensors = (t.w, t.wp) + (() if tw3 is None else tuple(tw3))
    return RegsLaunch(args, tuple(x3.shape), orientation, fc.modmul, _TWIDDLE[mode], tensors)


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, which a launch joins:
    the raw handle, as PyTorch's generated kernels read it
    (``torch.cuda.current_stream`` builds a ``Stream`` object first, 4 us
    of a 35 us replayed 2^17 call on the H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def call_regs(launch: RegsLaunch, src: int, out: int, stream: int) -> None:
    """The C call of a prepared launch: input at ``src``, output at
    ``out``, on ``stream``; counted."""
    from .. import _build

    rc = _build.load().sventt_radix2_ntt(src, out, *launch.args, stream)
    if rc != 0:
        raise RuntimeError(f"radix-2 register kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["radix2_registers"] += 1
    MODMUL[launch.modmul] += 1
    TWIDDLE[launch.twiddle] += 1
    if launch.orientation is not None:
        LAUNCHES[launch.orientation] += 1


#: The list ``recording`` appends this context's launches to.
_RECORD: contextvars.ContextVar[list | None] = contextvars.ContextVar("launch_record",
                                                                      default=None)


@contextlib.contextmanager
def recording():
    """Record the launches the block makes in this context -- the radix-2
    register kernel's and the tensor-core kernel's limb launches -- in
    order, as (launch, input pointer, output pointer, whether input and
    output each fill a dense block of ``launch.shape``'s size)."""
    record: list = []
    token = _RECORD.set(record)
    try:
        yield record
    finally:
        _RECORD.reset(token)


def record_launch(launch, src: int, out: int, dense: bool) -> None:
    """Append a launch to the record of the ``recording`` around it, if
    any (see ``recording``)."""
    record = _RECORD.get()
    if record is not None:
        record.append((launch, src, out, dense))


def _launch_regs(
    x3: torch.Tensor, t: FusedDirection | LaneDirection, fc: FieldConsts,
    tw3: MontPair | None, first: int, last: int, lane: bool = False,
    orientation: str | None = None,
) -> torch.Tensor:
    """One launch of the radix-2 register kernel on stages [first, last)
    of ``t`` along axis 1 of the (A, m, B) tensor ``x3`` (K4, or K5 with
    the (A, m, 1) inter-step twiddle ``tw3``; with ``lane`` K6 on the
    contiguous (rows, m, 1) ``x3``, its twiddle of the same shape), in
    ``butterfly_geometry``'s geometry, counted under ``orientation`` too."""
    with span("sventt.launch.radix2_registers"):
        launch = prepare_regs(x3, t, fc, tw3, first, last, lane, orientation)
        out = torch.empty_like(x3)
        call_regs(launch, x3.data_ptr(), out.data_ptr(), current_stream(x3.device))
    record_launch(launch, x3.data_ptr(), out.data_ptr(), x3.is_contiguous())
    return out


class LaunchProgram:
    """The launches of one eager planner walk, replayed on new data: each
    launch's prepared arguments (a ``RegsLaunch`` or an
    ``ntt_mxu.TcLimbLaunch``), launched in order on the current stream,
    each into a new dense block of its ``shape`` that the next reads; the
    first reads the caller's tensor, and the last's output, viewed as
    ``shape``, is the result.  A replay gives the walk's launches, geometry
    and counts; only the pointers and the stream are the call's own."""

    def __init__(self, launches: tuple, shape: tuple[int, ...]):
        self.launches = launches
        self.shape = shape

    @classmethod
    def from_record(cls, record: list, src: int, out: torch.Tensor) -> "LaunchProgram":
        """The program of a walk that read the tensor at ``src`` and
        returned ``out``, its launches ``record`` (``recording``'s): a chain
        on dense data, each launch reading the one before's output, the
        first ``src``, and ``out`` the last's."""
        for _, x_ptr, out_ptr, dense in record:
            if x_ptr != src or not dense:
                raise RuntimeError("the walk's launches are not a chain on dense data")
            src = out_ptr
        if not record or out.data_ptr() != src or not out.is_contiguous():
            raise RuntimeError("the walk's result is not its last launch's output")
        return cls(tuple(r[0] for r in record), tuple(out.shape))

    def __call__(self, x: torch.Tensor, donated: torch.Tensor | None = None) -> torch.Tensor:
        """The walk's result for ``x`` (contiguous, of the recorded shape);
        ``donated``'s storage is released once the first launch, the only
        one that reads it, is launched (as the planner's ``_release``)."""
        stream = current_stream(x.device)
        out = x
        for i, launch in enumerate(self.launches):
            src = out
            with span(launch.span):
                out = torch.empty(launch.shape, dtype=torch.int64, device=x.device)
                launch.call(src.data_ptr(), out.data_ptr(), stream)
            if i == 0 and donated is not None:
                donated.untyped_storage().resize_(0)
        PROGRAMS["replayed"] += 1
        return out.view(self.shape)


def _launch_grouped(
    x3: torch.Tensor, t: _GroupedTables, fc: FieldConsts, tw3: MontPair | None, lane: bool
) -> torch.Tensor:
    """One launch of the register kernel on every group of ``t`` (K7, or
    K8 with ``lane``) along axis 1 of the contiguous (A, m, B) tensor
    ``x3`` (see ``_view``), in ``grouped_geometry``'s geometry."""
    from .. import _build

    with span("sventt.launch.registers"):
        _check_cuda(t, fc, x3, tw3)
        m = t.m
        dims, strides, tw_strides = _view(x3, lane)
        w_ptr, wp_ptr, mode = _tw_args(tw3, fc)
        tw_words = 0 if tw3 is None else (1 if wp_ptr is None else 2)
        geo = grouped_geometry(
            m, t.specs, dims[2], lane, dims[0], tw_words, sm_count(x3.device.index)
        )
        ranks = sum(spec.R << (4 * g) for g, spec in enumerate(t.specs))
        lib = _build.load()
        out = torch.empty_like(x3)
        rc = lib.sventt_grouped_ntt(
            x3.data_ptr(), out.data_ptr(), t.w.data_ptr(), t.wp.data_ptr(),
            t.consts.data_ptr(), t.const_mask.data_ptr(), w_ptr, wp_ptr,
            dims[0], m.bit_length() - 1, dims[2], *strides, *tw_strides,
            len(t.specs), ranks, geo.cols.bit_length() - 1, geo.tpc.bit_length() - 1, geo.smem,
            int(t.inverse), _MODMUL[fc.modmul], int(fc.lazy), int(lane), mode, fc.modulus,
            fc.montgomery_inverse, torch.cuda.current_stream(x3.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"grouped kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["registers"] += 1
    return out


def _run(
    x3: torch.Tensor, t, fc: FieldConsts, tw3: MontPair | None, orientation: str
) -> torch.Tensor:
    """The orientation's kernel on a CUDA tensor (K4 / K5 one launch per
    ``spc`` stage range, each other kernel one launch), else the plain
    version."""
    check_companion(fc, tw3)
    lane = orientation.startswith("lane")
    grouped = isinstance(t, _GroupedTables)
    if x3.is_cuda:
        n = len(t.specs if grouped else t.stage_ls)
        step = n if grouped or lane else t.spc or n
        for first in range(0, n, step):
            if grouped:
                x3 = _launch_grouped(x3, t, fc, tw3, lane)
                LAUNCHES[orientation] += 1
            else:
                x3 = _launch_regs(x3, t, fc, tw3, first, min(first + step, n), lane, orientation)
        return x3
    if x3.device.type != "cpu":
        raise ValueError(f"butterfly engine runs on cpu or cuda tensors, got {x3.device}")
    PLAIN_CALLS[orientation] += 1
    return (_groups_plain if grouped else _stages_plain)(x3, t, fc, lane, tw3)


def fused_ntt(
    x: torch.Tensor, tables: FusedDirection | GroupedDirection, fc: FieldConsts
) -> torch.Tensor:
    """Length-m NTT along the leading axis of (m, batch...): K4 on
    per-stage tables, K7 on grouped ones."""
    if isinstance(tables, GroupedDirection):
        return fused_ntt_grouped(x, tables, fc)
    out = _run(_leaf_view(x, tables.m), tables, fc, None, "leaf")
    return out.reshape(x.shape)


def fused_ntt_grouped(x: torch.Tensor, tables: GroupedDirection, fc: FieldConsts) -> torch.Tensor:
    """Length-m NTT along the leading axis of (m, batch...) by radix-2^R
    groups, all in one launch (K7)."""
    return _run(_leaf_view(x, tables.m), tables, fc, None, "grouped").reshape(x.shape)


def fused_ntt_mid(
    x: torch.Tensor, tables: FusedDirection, fc: FieldConsts, tw: MontPair | None = None
) -> torch.Tensor:
    """Length-m NTT along axis 1 of (A, m, batch...) (K5).

    ``tw``: optional (A, m) inter-step MontPair (Montgomery form, the
    companion may be None; plain and companion-free under Solinas),
    broadcast over the batch and fused: multiplied
    before the stages on the forward, after them on the inverse.  Per-stage
    tables only: the planner runs a grouped row by the transpose fallback.
    """
    if not isinstance(tables, FusedDirection):
        raise TypeError(
            f"fused_ntt_mid takes per-stage FusedDirection tables, got "
            f"{type(tables).__name__} (a grouped row runs between transposes)"
        )
    x3 = _mid_view(x, tables.m)
    tw3 = None if tw is None else _mid_tw(tw, x3)
    return _run(x3, tables, fc, tw3, "mid").reshape(x.shape)


def fused_ntt_lane(
    x: torch.Tensor, tables: LaneDirection | GroupedLaneDirection, fc: FieldConsts,
    pre_tw: MontPair | None = None,
) -> torch.Tensor:
    """Length-m NTT along the LAST axis of (batch..., m): K6 on per-stage
    tables, K8 on grouped ones.

    ``pre_tw``: optional inter-step MontPair in the data's layout, fused as
    prologue (forward) / epilogue (inverse).
    """
    rows = _lane_rows(x, tables.m)
    tw3 = None if pre_tw is None else _lane_tw(pre_tw, x, rows)
    if isinstance(tables, GroupedLaneDirection):
        out = _run(rows.unsqueeze(2), tables, fc, tw3, "lane_grouped")
    else:
        out = _run(rows.unsqueeze(2), tables, fc, tw3, "lane")
    return out.reshape(x.shape)


def reset_counts() -> None:
    """Set every launch, plain-call, multiply, twiddle and program count to
    zero."""
    for d in (LAUNCHES, PLAIN_CALLS, KERNEL_LAUNCHES, PROGRAMS, MODMUL, TWIDDLE):
        for k in d:
            d[k] = 0


# ctypes signatures of the C entries in csrc/ntt_radix2.cu and
# csrc/ntt_grouped.cu
_RADIX2_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_longlong] * 5
    + [ctypes.c_int] * 2
    + [ctypes.c_ulonglong]
    + [ctypes.c_int] * 8
    + [ctypes.c_ulonglong] * 4
    + [ctypes.c_void_p]
)
_GROUPED_REG_ARGTYPES = (
    [ctypes.c_void_p] * 8
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int, ctypes.c_ulonglong]
    + [ctypes.c_int] * 8
    + [ctypes.c_ulonglong] * 2
    + [ctypes.c_void_p]
)
