"""A run with the timed path broken underneath reads ``correct`` false.

Each run here is a whole run of a cell but for the look for a card: the
program on the CPU (its kernels' plain versions) at a small length, the
same caller, check and result line.  The faults are those a cell can
have: a call that returns its input unchanged, an answer altered where it
is produced.  No cell exchanges data between chips, and no cell batches
transforms in a call, so the faults of a left-out exchange and of half a
batch left out have no cell here.  The control (the reference with float64
products in the program's place) fails too.
"""

import pytest
import torch

from bench_port import harness, spec
from bench_port.systems.ntt import System

BENCH = spec.load_benchmark()
#: A small size of each cell that a test run holds.
SMALL = {
    "flagship-2p24.roundtrip": {"n": 1024},
    "flagship-2p24.polymul": {"n": 1024},
    "flagship-2p24.sync": {"n": 1024},
    "flagship-2p17.sync": {"n": 512},
}


def run(cell, system=None, seed=2**31 + 5):
    result, _ = harness.run_cell(BENCH, cell, seed, 0.2, False, device="cpu", system=system,
                                 **SMALL[cell])
    return result


def test_every_cell_has_a_small_size():
    assert set(SMALL) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["outputs_compared"]["value"] >= 1
    for m in spec.metrics_for(BENCH, cell, trace=False):
        assert m["name"] in r["metrics"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    r = run(cell, harness.ControlSystem)
    assert not r["correct"]
    wrong = {k: v["value"] for k, v in r["checks"].items() if k.endswith("_wrong_words")}
    assert wrong and all(v > 0 for v in wrong.values()), wrong


def unchanged(x):
    return x.clone()


def altered(y):
    y = y.clone()
    y.view(-1)[y.numel() // 3] ^= 1
    return y


class Fault(System):
    """The program with ``fault`` (a name) in its ``where`` call."""

    fault = ""
    where = ""

    def _broken(self, call, *args):
        x = args[0]
        if self.fault == "unchanged":
            return unchanged(x)
        return altered(call(*args))

    def forward(self, x):
        if self.where == "forward":
            return self._broken(super().forward, x)
        return super().forward(x)

    def inverse(self, x):
        if self.where == "inverse":
            return self._broken(super().inverse, x)
        return super().inverse(x)

    def polymul(self, a, b):
        if self.where == "polymul":
            return self._broken(super().polymul, a, b)
        return super().polymul(a, b)


CASES = [
    ("flagship-2p24.roundtrip", "unchanged", "forward"),
    ("flagship-2p24.roundtrip", "unchanged", "inverse"),
    ("flagship-2p24.roundtrip", "altered", "forward"),
    ("flagship-2p24.roundtrip", "altered", "inverse"),
    ("flagship-2p24.polymul", "unchanged", "polymul"),
    ("flagship-2p24.polymul", "altered", "polymul"),
    ("flagship-2p24.sync", "unchanged", "forward"),
    ("flagship-2p24.sync", "altered", "forward"),
    ("flagship-2p17.sync", "unchanged", "forward"),
    ("flagship-2p17.sync", "altered", "forward"),
]


@pytest.mark.parametrize("cell,fault,where", CASES, ids=["-".join(c) for c in CASES])
def test_a_broken_timed_path_is_not_correct(cell, fault, where):
    r = run(cell, type("Broken", (Fault,), {"fault": fault, "where": where}))
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def test_every_cell_has_its_faults():
    assert {c for c, _, _ in CASES} == set(SMALL)


def test_a_failing_call_is_not_correct():
    class Raises(System):
        def forward(self, x):
            raise torch.cuda.OutOfMemoryError("no room")

    r = run("flagship-2p24.sync", Raises)
    assert not r["correct"] and r["failed"] == r["attempted"]
    assert r["checks"]["outputs_compared"]["value"] == 0
