"""The multi-modular cell ``rns32-2p17.polymul``: its run on the CPU at a
small length (the program's plain versions, every one of its 32 limbs),
the control and the faults of its timed path, its op's judge, and the
readers of its roofline shares on synthetic traces with answers worked out
by hand."""

import types

import pytest
import torch

from bench_port import check, devtrace, harness, spec, yardstick
from bench_port.ops import rns_polymul
from bench_port.reference.ntt import ReferenceNTT, s64, ult
from bench_port.reference.rns import ReferenceRNS
from bench_port.systems.rns import System

BENCH = spec.load_benchmark()
CELL = "rns32-2p17.polymul"
#: The small length a test run holds.
SMALL_N = 256


def run(system=None, seed=2**31 + 7):
    result, _ = harness.run_cell(BENCH, CELL, seed, 0.2, False, device="cpu", system=system,
                                 n=SMALL_N)
    return result


def test_the_cell_resolves_to_the_rns_files():
    w = spec.workload(BENCH, CELL)
    config = spec.load_config(BENCH, w["config"])
    assert (config["system"], config["reference"]) == ("rns", "rns")
    assert spec.load_traffic(w["traffic"])["op"] == "rns_polymul"
    assert len(config["moduli"]) == len(config["generators"]) == 32
    assert (config["modulus"], config["generator"]) == (config["moduli"][0],
                                                        config["generators"][0])
    assert [int(h, 16) for h in config["moduli_hex"]] == config["moduli"]
    for q in config["moduli"]:
        assert q < 1 << 64 and (q - 1) % config["n"] == 0


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["outputs_compared"]["value"] >= 1
    for m in spec.metrics_for(BENCH, CELL, trace=False):
        assert m["name"] in r["metrics"]


def test_the_control_is_not_correct():
    r = run(harness.ControlSystem)
    assert not r["correct"]
    assert r["checks"]["rns_polymul_wrong_words"]["value"] > 0


class Fault(System):
    """The program with ``fault`` in its product."""

    fault = ""

    def polymul(self, a, b):
        if self.fault == "unchanged":
            return a.clone()
        y = super().polymul(a, b).clone()
        y[-1, y.shape[1] // 3] ^= 1  # one word of the last limb
        return y


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    r = run(type("Broken", (Fault,), {"fault": fault}))
    assert not r["correct"], r["checks"]
    assert r["failed"] >= 1


def test_wrong_counts_a_planted_word_in_one_limb():
    config = {"moduli": [0xffffffffffe40001, 0xffffffffffc60001, 0xfffffffff8200001],
              "generators": [11, 7, 3], "n": 64}
    gen = torch.Generator()
    gen.manual_seed(3)
    inputs = rns_polymul.make_inputs({"coefficients": 0.5}, config, gen, torch.device("cpu"))
    assert rns_polymul.WORK["limb_products"] == 3
    a, b = inputs["a"], inputs["b"]
    assert a.shape == (4, 3, 64) and not a[:, :, 32:].any() and not b[:, :, 32:].any()
    for i, q in enumerate(config["moduli"]):  # each limb's residues lie below its modulus
        assert bool(ult(a[:, i], s64(q)).all() and ult(b[:, i], s64(q)).all())
    ref = ReferenceRNS(config["moduli"], config["generators"], 64, "cpu")
    memo = check.Memo(ref, inputs)
    good = memo("polymul", 1, "a", "b").clone()
    assert rns_polymul.wrong((good,), inputs, 1, memo) == {"rns_polymul_wrong_words": 0}
    good[2, 5] ^= 1 << 40
    assert rns_polymul.wrong((good,), inputs, 1, memo) == {"rns_polymul_wrong_words": 1}


def test_the_reference_is_each_limbs_own():
    moduli, gens, n = [0xffffffffffe40001, 0xfffffffff8200001], [11, 3], 32
    ref = ReferenceRNS(moduli, gens, n, "cpu")
    x = torch.randint(0, 1 << 62, (2, n), dtype=torch.int64)
    y = torch.randint(0, 1 << 62, (2, n), dtype=torch.int64)
    for i, (q, g) in enumerate(zip(moduli, gens)):
        one = ReferenceNTT(q, g, n, "cpu")
        assert torch.equal(ref.forward(x)[i], one.forward(x[i]))
        assert torch.equal(ref.inverse(x)[i], one.inverse(x[i]))
        assert torch.equal(ref.polymul(x, y)[i], one.polymul(x[i], y[i]))
    with pytest.raises(ValueError):
        ref.forward(x[:1])


def kernel(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur}


TRANSFORM = "void (anonymous namespace)::mxu_tc_kernel<false, 0, 0, false, false, 0, true>(...)"
POINTWISE = "void (anonymous namespace)::pointwise_mont_mul_kernel<false, true>(...)"
COPY = "Memcpy DtoD (Device -> Device)"


def trace(kernels, work):
    # microseconds: the window [1000, 3000)
    events = [{"ph": "X", "name": "bench.window", "cat": "user_annotation", "ts": 1000,
               "dur": 2000}, *kernels]
    tr = devtrace.parse(events)
    tr.work = work
    return tr


def read(metric, tr, n=1 << 17):
    run = types.SimpleNamespace(n=n, window=types.SimpleNamespace(trace=tr))
    return spec.reader(metric)(run)


def test_the_roofline_readers():
    # two products of 32 limbs: transforms 400 + 500 us, pointwise 30 + 40,
    # a copy of 30: 1000 us on the device
    tr = trace([kernel(TRANSFORM, 1000, 400), kernel(POINTWISE, 1400, 30),
                kernel(TRANSFORM, 1500, 500), kernel(POINTWISE, 2000, 40),
                kernel(COPY, 2100, 30)], {"products": 2, "limb_products": 64})
    n = 1 << 17
    least = 64 * (3 * 16 + 24) * n / yardstick.HBM_BYTES_PER_S
    assert read("rns_roofline.rns32", tr) == pytest.approx(100 * least / 1000e-6)
    least_ntt = 64 * 3 * 16 * n / yardstick.HBM_BYTES_PER_S
    assert read("rns_ntt_roofline.rns32", tr) == pytest.approx(100 * least_ntt / 900e-6)
    least_pw = 64 * 24 * n / yardstick.HBM_BYTES_PER_S
    assert read("rns_pointwise_roofline.rns32", tr) == pytest.approx(100 * least_pw / 70e-6)
    # by hand: 64 limb products' 24 bytes a point of 2^17 = 201,326,592 bytes,
    # 60.098 us at 3.35 TB/s, over 70 us
    assert read("rns_pointwise_roofline.rns32", tr) == pytest.approx(85.854, abs=1e-3)


ROOFLINES = ["rns_roofline.rns32", "rns_ntt_roofline.rns32", "rns_pointwise_roofline.rns32"]


@pytest.mark.parametrize("metric", ROOFLINES)
@pytest.mark.parametrize("kernels,work", [
    ([], {"products": 2, "limb_products": 64}),  # nothing on the device
    ([kernel(TRANSFORM, 1000, 400), kernel(POINTWISE, 1400, 30)], {"products": 2}),  # no limbs
    ([kernel(TRANSFORM, 1000, 400)], {}),  # no product in the traced part
], ids=["empty", "no-limb-products", "no-products"])
def test_nothing_to_read(metric, kernels, work):
    assert read(metric, trace(kernels, work)) is None


@pytest.mark.parametrize("metric", ROOFLINES[1:])
def test_nothing_to_read_without_the_named_kernel(metric):
    tr = trace([kernel(COPY, 1000, 400)], {"products": 1, "limb_products": 32})
    assert read(metric, tr) is None


@pytest.mark.parametrize("metric", ROOFLINES)
def test_nothing_to_read_in_an_untraced_run(metric):
    assert read(metric, None) is None
