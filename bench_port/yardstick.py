"""The yardstick: peaks, the bytes a transform must move, and the
statistics the metric readers share.

The roofline reads bytes only.  A transform must read its input once and
write its output once, 8 + 8 bytes a point, whatever engine computes it;
an operation count would change with the engine (int8 planes or radix-2
butterflies) and go stale, or read over 100%, once a change swapped it.
The byte rule and the HBM peak are ``chip_smoke.py``'s (``HBM_BPS``,
``mxu_bound``'s 16 bytes a point).
"""

from __future__ import annotations

import math

#: H100 SXM HBM3 bandwidth, NVIDIA's data sheet (at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12

WORD = 8


def transform_bytes(n: int) -> int:
    """Least bytes of one transform of n words: input read once, output
    written once."""
    return 2 * WORD * n


def pointwise_bytes(n: int) -> int:
    """Least bytes of the pointwise product of two spectra: two read, one
    written."""
    return 3 * WORD * n


def polymul_bytes(n: int) -> int:
    """Least bytes of one cyclic product: two forwards, the pointwise
    product, one inverse."""
    return 3 * transform_bytes(n) + pointwise_bytes(n)


def least_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all ``values`` (0 < q <= 100)."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def merge(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted,
    disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which at least one interval runs."""
    return sum(e - s for s, e in merge(intervals, lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in merge(intervals, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    return gaps
