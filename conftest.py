"""Test scheduling for a run spread over workers (``-p xdist --dist loadfile``).

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
  longer than any other file, and behind it the rest of its file, or
  whatever unit xdist queued on that worker, would end the run late.

The seconds are one worker's time per unit, summed from the per-test
``time`` of the junit XML of a whole run of ``tests/`` on 6 workers.
Remeasure them when a unit's time changes by much.  No test is skipped,
marked or changed, and nothing here imports jax or torch.
"""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Tests that are a work unit of their own, and their seconds.
SOLO_SECONDS = {
    "tests/test_wrapper.py::test_solinas_pallas_engine_matches_golden": 1182.4,
}

#: Seconds of one worker's time per test file (less its SOLO_SECONDS tests).
FILE_SECONDS = {
    "tests/test_ntt_pallas.py": 904.8,
    "tests/test_ntt_grouped.py": 666.5,
    "tests/test_parallel.py": 502.4,
    "tests/test_apps.py": 487.6,
    "tests/test_torch_ntt_jnp.py": 333.9,
    "tests/test_torch_ntt_radix2_regs.py": 295.4,
    "tests/test_torch_parallel.py": 222.7,
    "tests/test_wrapper.py": 236.4,
    "tests/test_ntt_mid.py": 205.2,
    "tests/test_torch_ntt_pallas.py": 182.5,
    "tests/test_torch_ntt_pallas_rows.py": 180.5,
    "tests/test_torch_solinas_plan.py": 177.8,
    "tests/test_ntt_mxu.py": 153.5,
    "tests/test_torch_solinas_rows.py": 136.9,
    "tests/test_torch_apps.py": 123.9,
    "tests/test_torch_transpose.py": 108.7,
    "tests/test_ntt_jnp.py": 103.2,
    "tests/test_ring.py": 103.1,
    "tests/test_autotune.py": 102.8,
    "tests/test_torch_ntt_grouped_regs.py": 101.2,
    "tests/test_torch_ntt_mxu_schemes.py": 98.9,
    "tests/test_torch_ntt_pallas_plan.py": 95.4,
    "tests/test_torch_ntt_grouped_lane.py": 95.3,
    "tests/test_torch_ntt_grouped.py": 83.6,
    "tests/test_torch_strategy.py": 83.0,
    "tests/test_twiddle_device.py": 80.8,
    "tests/test_torch_ntt_grouped_plan.py": 78.8,
    "tests/test_torch_solinas_kernels.py": 78.0,
    "tests/test_utils.py": 71.3,
    "tests/test_torch_ntt_mxu.py": 68.0,
    "tests/test_torch_ntt.py": 83.5,
    "tests/test_torch_ntt_mxu_tc.py": 58.5,
    "tests/test_budget.py": 51.5,
    "tests/test_torch_ring.py": 26.3,
    "tests/test_limb.py": 21.1,
    "tests/test_torch_ntt_mxu_tc_u7.py": 19.1,
    "tests/test_torch_budget.py": 14.0,
    "tests/test_torch_autotune.py": 29.9,
    "tests/test_torch_utils.py": 7.4,
    "tests/test_torch_solinas.py": 13.0,
    "tests/test_torch_twiddle.py": 11.0,
    "tests/test_native_series.py": 6.9,
    "tests/test_torch_mxu_fused.py": 4.8,
    "tests/test_torch_field.py": 4.7,
    "tests/test_transpose.py": 3.4,
    "tests/test_modulus.py": 1.7,
    "tests/test_truetime.py": 1.0,
    "tests/test_native.py": 0.1,
    "tests/test_torch_native_series.py": 0.2,
    "tests/test_golden.py": 0.1,
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
