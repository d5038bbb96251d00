"""Test scheduling for a run spread over workers (``-p xdist --dist loadfile``).

Each xdist worker gets its share of the CPUs for torch and OpenMP:
``max(1, os.cpu_count() // worker count)`` threads, set as
``OMP_NUM_THREADS`` when this file is imported, before torch is (and by
``torch.set_num_threads`` in ``pytest_configure`` had a plugin loaded
torch first).  torch's intra-op pool otherwise takes every CPU in every
worker, and six workers on eight CPUs run 48 threads that spin against
each other: ``tests/test_torch_ntt_radix2_regs.py::test_geometry_limits``
took 9.2 s alone and 143.3 s in a whole run on six such workers.  A run
without xdist, or one whose caller set ``OMP_NUM_THREADS``, keeps its
threads.  XLA's own thread settings are left as they are.

xdist hands out whole files as work units, by default the files with the
most collected items first.  The run ends when its slowest worker ends, and
a slow file with few items started late.  Here the units go out by their
measured seconds instead, longest first (longest processing time first):

* ``pytest_configure`` turns xdist's reordering by item count off, so the
  units keep the collection order;
* ``pytest_collection_modifyitems`` stable-sorts the items by the seconds
  of their unit, ``SOLO_SECONDS`` for a test listed there, else
  ``FILE_SECONDS`` for its file.  Files in neither table follow, in
  collected order; the order within a file does not change;
* ``pytest_xdist_make_scheduler`` makes each test of ``SOLO_SECONDS`` a
  work unit of its own, and a worker running one takes only the smallest
  unit left (a worker runs its last queued test only once it holds
  another) until it ends: one test of ``tests/test_wrapper.py`` takes
  longer than any other file, and its file with it longer than a sixth
  of the suite's worker-seconds, so behind it the rest of its file, or
  whatever unit xdist queued on that worker, would end the run late.

The seconds are one worker's time per unit, summed from the per-test
``time`` of the junit XML of a whole run of ``tests/`` on 6 workers with
the thread rule above (8 CPUs: 6,610 worker-seconds, 1,155 s of wall
time).  Remeasure them when a unit's time changes by much.  No test is
skipped, marked or changed, and nothing here imports jax or torch.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def worker_threads(environ, cpus: int | None) -> int | None:
    """The torch / OpenMP threads of an xdist worker with ``environ`` on
    ``cpus`` CPUs, or None for a run without xdist or a caller's own
    ``OMP_NUM_THREADS``."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers or "OMP_NUM_THREADS" in environ:
        return None
    return max(1, (cpus or 1) // int(workers))


#: The threads this process was given (None: left as they were).
WORKER_THREADS = worker_threads(os.environ, os.cpu_count())
if WORKER_THREADS is not None:
    os.environ["OMP_NUM_THREADS"] = str(WORKER_THREADS)

#: Tests that are a work unit of their own, and their seconds.
SOLO_SECONDS = {
    "tests/test_wrapper.py::test_solinas_pallas_engine_matches_golden": 1010.3,
}

#: Seconds of one worker's time per test file (less its SOLO_SECONDS tests).
FILE_SECONDS = {
    "tests/test_ntt_pallas.py": 729.3,
    "tests/test_ntt_grouped.py": 621.3,
    "tests/test_apps.py": 449.4,
    "tests/test_parallel.py": 420.4,
    "tests/test_wrapper.py": 357.1,
    "tests/test_torch_ntt_jnp.py": 341.4,
    "tests/test_ntt_mid.py": 231.2,
    "tests/test_ntt_mxu.py": 161.6,
    "tests/test_torch_ntt_pallas_rows.py": 152.6,
    "tests/test_torch_ntt_pallas.py": 148.5,
    "tests/test_torch_apps.py": 141.7,
    "tests/test_torch_parallel.py": 120.4,
    "tests/test_ntt_jnp.py": 115.8,
    "tests/test_torch_ntt_pallas_plan.py": 111.0,
    "tests/test_autotune.py": 99.7,
    "tests/test_torch_ntt.py": 99.3,
    "tests/test_torch_ntt_grouped_plan.py": 91.5,
    "tests/test_torch_ntt_mxu_schemes.py": 83.2,
    "tests/test_ring.py": 82.4,
    "tests/test_torch_solinas_plan.py": 81.4,
    "tests/test_torch_ntt_grouped_lane.py": 76.1,
    "tests/test_torch_ntt_radix2_regs.py": 75.5,
    "tests/test_torch_solinas_rows.py": 70.1,
    "tests/test_utils.py": 67.7,
    "tests/test_torch_ntt_mxu.py": 67.3,
    "tests/test_torch_ntt_mxu_tc.py": 64.1,
    "tests/test_twiddle_device.py": 63.3,
    "tests/test_torch_ntt_grouped.py": 61.1,
    "tests/test_torch_transpose.py": 52.9,
    "tests/test_torch_solinas_kernels.py": 48.7,
    "tests/test_budget.py": 46.5,
    "tests/test_torch_ntt_grouped_regs.py": 43.0,
    "tests/test_torch_strategy.py": 42.2,
    "tests/test_torch_rns.py": 53.6,
    "tests/test_torch_autotune.py": 27.7,
    "tests/test_limb.py": 20.2,
    "tests/test_torch_ntt_mxu_tc_u7.py": 18.5,
    "tests/test_torch_twiddle.py": 15.5,
    "tests/test_torch_tracing.py": 12.9,
    "tests/test_torch_solinas.py": 9.5,
    "tests/test_torch_launch_program.py": 6.0,
    "tests/test_torch_ring.py": 9.5,
    "tests/test_torch_field.py": 7.3,
    "tests/test_native_series.py": 6.6,
    "tests/test_torch_utils.py": 6.3,
    "tests/test_transpose.py": 5.6,
    "tests/test_truetime.py": 2.4,
    "tests/test_modulus.py": 2.4,
    "tests/test_torch_flagship_2p28.py": 2.3,
    "tests/test_torch_mxu_fused.py": 2.1,
    "tests/test_torch_goldilocks.py": 2.0,
    "tests/test_torch_budget.py": 1.8,
    "tests/test_torch_pointwise.py": 0.5,
    "tests/test_torch_native_series.py": 0.3,
    "tests/test_native.py": 0.1,
    "tests/test_golden.py": 0.1,
    "tests/test_torch_tier1.py": 0.0,
}


def _solo(nodeid: str) -> str | None:
    """The SOLO_SECONDS test a node id belongs to (its parametrized cases
    included), or None."""
    for test in SOLO_SECONDS:
        if nodeid == test or nodeid.startswith(test + "["):
            return test
    return None


def _rank(item) -> float:
    try:
        rel = Path(item.path).resolve().relative_to(ROOT).as_posix()
    except ValueError:
        return 0.0
    solo = _solo(f"{rel}::{item.name}")
    return -(SOLO_SECONDS[solo] if solo else FILE_SECONDS.get(rel, 0.0))


def pytest_configure(config):
    if WORKER_THREADS is not None and "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(WORKER_THREADS)
    # keep the collection order below when xdist assigns files to workers
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(session, config, items):
    items.sort(key=_rank)  # stable: unlisted files and each file's order stay


def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SoloScheduling(LoadFileScheduling):
        """``--dist loadfile`` with each SOLO_SECONDS test a unit of its
        own, whose worker waits for it to end before it takes more."""

        def _split_scope(self, nodeid: str) -> str:
            return _solo(nodeid) or super()._split_scope(nodeid)

        def _reschedule(self, node) -> None:
            work = self.assigned_work.get(node, {})
            if self.workqueue and any(
                scope in SOLO_SECONDS and not all(done.values()) for scope, done in work.items()
            ):
                # a worker starts its last queued test only once it holds
                # another or is told to stop: queue the smallest unit once
                # behind the solo test, and nothing more until that ends
                if self._pending_of(work) < 2:
                    self.workqueue.move_to_end(next(reversed(self.workqueue)), last=False)
                    self._assign_work_unit(node)
                return
            super()._reschedule(node)

    return SoloScheduling(config, log)
