"""The device trace of a traced run: ``torch.profiler`` over a short steady
part of the window, read back from its Chrome trace.

The traced part starts and ends on an idle device (the caller drains the
stream first) inside the benchmark's own span ``bench.window``, so every
kernel of the calls in it lies inside the span and nothing else does.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import warnings
from collections import defaultdict
from dataclasses import dataclass, field

from . import yardstick

WINDOW_SPAN = "bench.window"
#: Chrome-trace categories of work on the device, and of the host's spans.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: Entries of each list of the breakdown.
TOP = 10
#: Longest name kept in the breakdown.
NAME_CHARS = 160


@dataclass
class Trace:
    """What one traced part of a window holds, times in seconds."""

    window_s: float
    busy_s: float
    #: (name, start, duration) of each device operation in the window.
    ops: list
    #: (name, start, end) of the host's spans in the window.
    host: list = field(repr=False)
    lo: float = 0.0
    hi: float = 0.0
    #: Work the caller completed in the traced part, as ``Window.work``.
    work: dict = field(default_factory=dict)

    def device_seconds(self, match=lambda name: True) -> float:
        """Summed duration of the device operations whose name matches."""
        return sum(d for name, _, d in self.ops if match(name))

    def idle_percent(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each as [[name, seconds], ...]."""
        by_op: dict[str, float] = defaultdict(float)
        for name, _, d in self.ops:
            by_op[name[:NAME_CHARS]] += d
        intervals = [(s, s + d) for _, s, d in self.ops]
        by_host: dict[str, float] = defaultdict(float)
        label = _Labeller(self.host)
        for s, e in yardstick.idle_gaps(intervals, self.lo, self.hi):
            by_host[label((s + e) / 2)] += e - s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


class _Labeller:
    """Names what the host was doing at an instant: the benchmark's span
    around the call and the innermost host operation running."""

    def __init__(self, host):
        self.bench = sorted((s, e, n) for n, s, e in host if n.startswith("bench.")
                            and n != WINDOW_SPAN)
        self.other = sorted((s, e, n) for n, s, e in host if not n.startswith("bench."))
        self.bench_starts = [s for s, _, _ in self.bench]
        self.other_starts = [s for s, _, _ in self.other]

    @staticmethod
    def _find(starts, spans, t, look=64):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - look), -1):
            if spans[j][1] >= t:
                return spans[j][2]
        return None

    def __call__(self, t: float) -> str:
        outer = self._find(self.bench_starts, self.bench, t) or "bench.loop"
        inner = self._find(self.other_starts, self.other, t)
        return f"{outer} / {inner[:NAME_CHARS]}" if inner else outer


def parse(events: list) -> Trace:
    """A Trace from the events of a Chrome trace with one ``bench.window``."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if len(spans) != 1:
        raise ValueError(f"expected one {WINDOW_SPAN} span, found {len(spans)}")
    lo = spans[0]["ts"] * 1e-6
    hi = lo + spans[0]["dur"] * 1e-6
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = e["ts"] * 1e-6, e["dur"] * 1e-6
        if e.get("cat") in DEVICE_CATS:
            s0, s1 = max(s, lo), min(s + d, hi)
            if s1 > s0:
                ops.append((e.get("name", "?"), s0, s1 - s0))
        elif e.get("cat") in HOST_CATS and s < hi and s + d > lo:
            host.append((e.get("name", "?"), s, s + d))
    busy = yardstick.busy_seconds([(s, s + d) for _, s, d in ops], lo, hi)
    return Trace(window_s=hi - lo, busy_s=busy, ops=ops, host=host, lo=lo, hi=hi)


class Recorder:
    """Profiles the device and the host from ``start`` to ``stop``."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> Trace:
        """Ends the span once the device is idle, and reads the trace."""
        self._torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        with warnings.catch_warnings():  # the note that a cycle's events are cleared
            warnings.simplefilter("ignore", UserWarning)
            self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return parse(events)
