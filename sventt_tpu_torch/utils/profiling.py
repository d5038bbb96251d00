"""Profiling hooks: ``torch.profiler`` traces and a per-level timing budget.

The counterpart of ``sventt_tpu/utils/profiling.py``.  ``trace`` writes a
Chrome trace of the enclosed block; ``phase_breakdown`` times each level of
a plan as a standalone program at the plan's own shapes, by
``utils.timing.time_chained`` (CUDA-graph replays on the card).
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA where
    there is a card) of the enclosed block into a Chrome trace file in
    ``log_dir`` (``tensorboard_trace_handler``'s ``*.pt.trace.json``).

    Usage::

        with trace("/tmp/ntt-trace"):
            ntt.compute_forward(x)
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def phase_breakdown(ntt, seconds: float = 1.0, seed: int = 0) -> dict[str, float]:
    """Per-level timing budget of ``ntt``'s forward transform (ms).

    Walks the plan tree and times, as standalone programs at the plan's own
    intermediate shapes on the NTT's device: each split level's row step
    (the chunked axis-1 row transform with its inter-step multiply, for jnp
    rows; the inter-step multiply alone otherwise -- the row kernels fuse
    it, so this is what it would cost as a pass of its own) and the final
    column leaf, plus the whole transform.  The labels are the JAX
    package's.  The port keeps every level's twiddle in its (m0, m1)
    layout, so no table is transposed first.  ``seed`` is unused (the
    inputs are an iota below n), as in the JAX package.
    """
    from ..ops import inter_step
    from ..plan import planner
    from .timing import time_chained

    tabs = ntt._fwd_tables
    if tabs is None:
        raise RuntimeError("forward transform was not enabled")
    fc = ntt.fc
    device = ntt.device

    def dev(shape):
        return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)

    def chain(f, x, *tables):
        return time_chained(f, x, tables, seconds=seconds, reps=1).ms

    out: dict[str, float] = {}
    plan = ntt.plan
    out["total"] = chain(
        lambda v, t: planner.run_forward(v, plan, t), dev((ntt.config.n,)), tabs
    )
    node, batch, level = plan, (), 0
    while isinstance(node, planner.Split):
        m0, m1 = node.m0, node.m1
        shape = (m0, m1) + batch
        tw = tabs.split_tw[(m0, m1)]
        if planner._jnp_row(node):
            def f(v, t, tw):
                return planner._jnp_mid_chunked(v, t, fc, tw, False, tabs.chunk_elems)

            out[f"level{level}.rows m1={m1} (+tw, fused chunks)"] = chain(
                f, dev(shape), tabs.leaf[(m1, "jnp")], tw
            )
        else:
            out[f"level{level}.inter-step tw {m0}x{m1}"] = chain(
                lambda v, tw: inter_step.mont_mul_bcast(fc, v, tw), dev(shape), tw
            )
        node, batch, level = node.col, (m1,) + batch, level + 1
    leaf = node
    out[f"level{level}.col leaf m={leaf.m}"] = chain(
        lambda v, t: planner.run_forward(v, leaf, t), dev((leaf.m,) + batch), tabs
    )
    return out
