"""The general generator and caller of every traffic mix.

A mix is a data file under ``traffic/`` with these keys:

* ``op``: the operation, ``ops/<op>.py``: ``"forward"`` (one forward a
  call), ``"roundtrip"`` (the forward of an input, then the inverse of
  that output) or ``"polymul"`` (one cyclic product a call);
* ``coefficients``: ``polymul`` only, the share of the length that holds
  random coefficients, the rest zero;
* ``inflight``: calls in flight at most, bounded by CUDA events, for a
  caller that does not wait for each result;
* ``sync``: wait for each call's output before the next, and time each
  call on the host's clock until the wait returns (no ``inflight``).

What does not vary with the traffic is the harness's: the ring of
inputs, the warm-up, the sample kept for the check and the traced part
(the constants below).  Inputs are uniform residues below N, made on the
device from the seed in a few large calls; the seed changes values, never
sizes or order.
"""

from __future__ import annotations

import collections
import contextlib
import random
import sys
import time
from dataclasses import dataclass, field

import torch

from . import devtrace, spec

#: Distinct inputs (pairs for a product), used in turn.
RING = 4
#: Calls made in set-up, on the same inputs and shapes.
WARMUP_CALLS = 8
#: Units of work kept from the window for the check, drawn from the seed.
SAMPLES = 4
#: The traced part at the end of a ``--trace 1`` window: seconds, and
#: calls at least.
TRACE_SECONDS = 1.0
TRACE_MIN_CALLS = 16


@dataclass
class Window:
    """What the caller did and saw in one measured stretch."""

    seconds: float = 0.0
    calls: int = 0
    #: Work completed, by the op's ``WORK`` keys ("transforms", "products").
    work: dict = field(default_factory=dict)
    failed: int = 0
    #: Host seconds of each call into the program until it returned,
    #: outside the traced part.
    host_call_s: list = field(default_factory=list)
    #: Host-clock ms of each synchronous call, from the call until the wait
    #: for its output returned, outside the traced part (``sync`` only).
    latency_ms: list = field(default_factory=list)
    #: Kept units of work: (ring index, outputs of its calls).
    samples: list = field(default_factory=list)
    trace: devtrace.Trace | None = None


def _words(shape, gen, device) -> torch.Tensor:
    """Uniform 64-bit words, as int64 bit patterns."""
    hi = torch.randint(0, 1 << 32, shape, generator=gen, device=device, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=device, dtype=torch.int64)
    return (hi << 32) | lo


def residues(shape, modulus: int, gen, device) -> torch.Tensor:
    """Residues below N, near uniform: a word at or above N (a share of
    2^-22 for the flagship) is reduced by N once."""
    x = _words(shape, gen, device)
    sign = -(1 << 63)
    n64 = modulus - (1 << 64) if modulus >= 1 << 63 else modulus
    return torch.where((x ^ sign) < (n64 ^ sign), x, x - n64)


def make_inputs(mix: dict, config: dict, seed: int, device) -> dict:
    """The ring of inputs of a mix, made by its op from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return spec.op(mix["op"]).make_inputs(mix, config, gen, device)


class Reservoir:
    """A uniform sample of ``k`` of the items offered (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


class Caller:
    """Drives ``system`` with a mix: the op's calls, unit after unit, on the
    ring of inputs in turn."""

    def __init__(self, system, mix: dict, inputs: dict, device, chips: int = 1):
        self.system, self.inputs, self.chips = system, inputs, chips
        self.op = spec.op(mix["op"])
        self.sync = mix.get("sync", False)
        self.inflight = 1 if self.sync else mix["inflight"]
        #: Calls a unit of work takes: a window ends on a whole unit.
        self.unit_calls = len(self.op.steps(system, inputs, 0))
        self.cuda = torch.device(device).type == "cuda"
        self.profiling = False
        self._steps, self._outs = [], []

    def warm_up(self) -> None:
        """The mix's own calls on its own shapes, outside any window."""
        self.run(calls=WARMUP_CALLS, sample_seed=0)

    def run(self, *, seconds: float | None = None, calls: int | None = None,
            sample_seed: int, trace: bool = False) -> Window:
        """Issues calls for ``seconds`` (or ``calls`` of them), then waits
        for the device.  With ``trace`` the last TRACE_SECONDS are
        profiled, at least TRACE_MIN_CALLS calls."""
        w = Window()
        keep = Reservoir(SAMPLES, sample_seed)
        pending: collections.deque = collections.deque()
        recorder, seg = None, None
        k = 0
        t0 = time.perf_counter()
        deadline = None if seconds is None else t0 + seconds
        while True:
            now = time.perf_counter()
            if calls is not None:
                if k >= calls:
                    break
            else:
                if trace and recorder is None and now >= deadline - TRACE_SECONDS:
                    self._drain(pending)
                    recorder = devtrace.Recorder()
                    recorder.start()
                    self.profiling = True
                    # the profiler's start takes seconds: the traced part
                    # runs its full length after it
                    deadline = max(deadline, time.perf_counter() + TRACE_SECONDS)
                    seg = (k, dict(w.work))
                if (now >= deadline and k % self.unit_calls == 0
                        and (recorder is None or k - seg[0] >= TRACE_MIN_CALLS)):
                    break
            self._issue(k, w, keep, pending)
            k += 1
        self._drain(pending)
        w.seconds = time.perf_counter() - t0
        w.calls = k
        if recorder is not None:
            w.trace = recorder.stop()
            self.profiling = False
            w.trace.work = {key: v - seg[1].get(key, 0) for key, v in w.work.items()}
        w.samples = keep.items
        self._steps, self._outs = [], []
        return w

    def _drain(self, pending) -> None:
        pending.clear()
        if self.cuda:
            for d in range(self.chips):
                torch.cuda.synchronize(d)

    def _span(self, name: str):
        if self.profiling:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _issue(self, k: int, w: Window, keep: Reservoir, pending) -> None:
        """Call ``k``: step ``j`` of unit ``u``, on the output of step j - 1."""
        u, j = divmod(k, self.unit_calls)
        i = u % RING
        if j == 0:
            self._steps, self._outs = self.op.steps(self.system, self.inputs, i), []
        name, call = self._steps[j]
        while len(pending) >= self.inflight:
            with self._span("bench.wait"):
                pending.popleft().synchronize()
        t = time.perf_counter()
        try:
            if len(self._outs) < j:
                raise RuntimeError("an earlier call of this unit failed")
            with self._span(name):
                y = call(self._outs[-1] if j else None)
        except Exception as e:  # a failed call is counted, and fails the run
            w.failed += 1
            if w.failed == 1:
                print(f"call {k} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            return
        if not self.profiling:  # the profiler's own host cost stays out
            w.host_call_s.append(time.perf_counter() - t)
        self._outs.append(y)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            if self.sync:
                with self._span("bench.wait"):
                    ev.synchronize()
            else:
                pending.append(ev)
        if self.sync and not self.profiling:
            w.latency_ms.append((time.perf_counter() - t) * 1e3)
        if j == self.unit_calls - 1:
            for key, v in self.op.WORK.items():
                w.work[key] = w.work.get(key, 0) + v
            keep.offer((i, tuple(self._outs)))
            self._outs = []
