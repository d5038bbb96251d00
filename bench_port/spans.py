"""The program's own spans in a traced part, as the span metrics read them.

The port names its host path with ``record_function`` spans while a
profiler records (``sventt_tpu_torch.utils.profiling.span``); they land in
the trace's host events beside the harness's ``bench.*`` spans and the CUDA
runtime's calls.  A program without them leaves nothing here to read, and
every function below then finds no call.

* A *call* is a ``sventt.forward``, ``sventt.inverse`` or
  ``sventt.convolve`` span inside no other of these (a product's forwards
  and inverse are part of its call).
* A *launch span* is a ``sventt.launch.<kernel>`` span: the host's work to
  launch one of the program's kernels.
* A *launch* is a host event whose name starts with one of
  ``LAUNCH_EVENTS``; one nested inside another (a ``cuLaunchKernel``
  under a ``cudaLaunchKernel``) is the same launch.
"""

from __future__ import annotations

import bisect

from . import yardstick

CALL_SPANS = ("sventt.forward", "sventt.inverse", "sventt.convolve")
LAUNCH_SPAN = "sventt.launch."
POINTWISE_SPAN = "sventt.convolve.pointwise"
LAUNCH_EVENTS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")


def outermost(intervals) -> list[tuple[float, float]]:
    """The (start, end) intervals that lie inside no other, sorted."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e))
    return out


def overlap_seconds(a, b) -> float:
    """Seconds that two lists of sorted, disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _spans(tr, match) -> list[tuple[float, float]]:
    return [(s, e) for name, s, e in tr.host if match(name)]


def calls(tr) -> list[tuple[float, float]]:
    """The calls into the program in the traced part, sorted."""
    return outermost(_spans(tr, lambda name: name in CALL_SPANS))


def launch_host_seconds(tr, within) -> float:
    """Host seconds inside the intervals ``within`` (sorted, disjoint) that
    some launch span covers."""
    launch = yardstick.merge(_spans(tr, lambda name: name.startswith(LAUNCH_SPAN)),
                             tr.lo, tr.hi)
    return overlap_seconds(launch, within)


def launches_in(tr, within) -> int:
    """Launches that start inside the intervals ``within`` (sorted,
    disjoint)."""
    firsts = [s for s, _ in within]
    n = 0
    for t, _ in outermost(_spans(tr, lambda name: name.startswith(LAUNCH_EVENTS))):
        i = bisect.bisect_right(firsts, t) - 1
        n += i >= 0 and t < within[i][1]
    return n


def pointwise(tr) -> list[tuple[float, float]]:
    """The products' pointwise steps in the traced part, sorted."""
    return outermost(_spans(tr, lambda name: name == POINTWISE_SPAN))
