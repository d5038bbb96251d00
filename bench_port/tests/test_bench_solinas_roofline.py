"""The reader of the Solinas kernels' share of their roofline
(``solinas_roofline.goldilocks``), on a synthetic trace with answers
worked out by hand, and the Goldilocks cell at a small size on the CPU."""

import types

import pytest

from bench_port import devtrace, harness, solinas_bytes, spec, yardstick

BENCH = spec.load_benchmark()
CELL = "goldilocks-2p24.roundtrip"


def kernel(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur}


def trace(kernels, transforms=2):
    # microseconds: the window [1000, 3000)
    events = [{"ph": "X", "name": "bench.window", "cat": "user_annotation", "ts": 1000,
               "dur": 2000}, *kernels]
    tr = devtrace.parse(events)
    tr.work = {"transforms": transforms}
    return tr


def run(tr, n=1 << 24):
    return types.SimpleNamespace(n=n, window=types.SimpleNamespace(trace=tr))


def read(metric, tr, n=1 << 24):
    return spec.reader(metric)(run(tr, n))


def reg(inv, mm, lane=False):
    """The demangled name of a radix-2 register-kernel instantiation."""
    b = lambda v: "true" if v else "false"
    return (f"void (anonymous namespace)::radix2_reg_kernel<{b(inv)}, {mm}, false, 4, "
            f"{b(not lane)}, {b(lane)}>((anonymous namespace)::R2Args)")


MXU = "void (anonymous namespace)::mxu_tc_kernel<false, 0, 1, false, false>(...)"


def test_only_the_solinas_instantiations_count():
    tr = trace([kernel(reg(False, 2), 1000, 300), kernel(reg(True, 2, lane=True), 1300, 100),
                kernel(reg(False, 0), 1400, 200), kernel(reg(True, 1), 1600, 200),
                kernel(MXU, 1800, 100)])
    n = 1 << 20
    least = 2 * yardstick.transform_bytes(n) / yardstick.HBM_BYTES_PER_S
    # 300 + 100 us of MM = 2; MM = 0, MM = 1 and the matrix kernel left out
    assert read("solinas_roofline.goldilocks", tr, n) == pytest.approx(100 * least / 400e-6)


@pytest.mark.parametrize("name,solinas", [
    (reg(False, 2), True), (reg(True, 2, lane=True), True),
    ("void (anonymous namespace)::radix2_reg_kernel<true,2,true,3,false,false>(...)", True),
    (reg(False, 0), False), (reg(True, 1), False), (MXU, False),
    ("void (anonymous namespace)::grouped_reg_kernel<false, 2, false, 3>(...)", False),
    ("void (anonymous namespace)::radix2_reg_kernel<false, 20, false, 4, true, false>(...)",
     False),
], ids=["leaf-fwd", "lane-inv", "unspaced", "montgomery", "shoup", "mxu", "grouped", "mm-20"])
def test_the_name_rule(name, solinas):
    assert solinas_bytes.is_solinas(name) == solinas


@pytest.mark.parametrize("kernels,transforms", [
    ([kernel(reg(False, 0), 1000, 400), kernel(MXU, 1500, 100)], 2),  # no Solinas kernel
    ([kernel(reg(False, 2), 1000, 400)], 0),  # no transform in the traced part
    ([], 2),
], ids=["montgomery-only", "no-transforms", "empty"])
def test_nothing_to_read_without_a_solinas_kernel(kernels, transforms):
    assert read("solinas_roofline.goldilocks", trace(kernels, transforms)) is None


def test_nothing_to_read_in_an_untraced_run():
    assert read("solinas_roofline.goldilocks", None) is None


def test_it_equals_the_ntt_roofline_when_every_operation_is_solinas():
    tr = trace([kernel(reg(False, 2), 1000, 280), kernel(reg(False, 2), 1300, 330),
                kernel(reg(False, 2, lane=True), 1650, 360),
                kernel(reg(True, 2, lane=True), 2050, 430)], transforms=2)
    want = read("ntt_roofline.goldilocks", tr)
    assert want is not None
    assert read("solinas_roofline.goldilocks", tr) == pytest.approx(want)


def test_the_cell_names_its_configuration_and_metrics():
    w = spec.workload(BENCH, CELL)
    config = spec.load_config(BENCH, w["config"])
    assert (config["modulus"], config["generator"]) == (2**64 - 2**32 + 1, 7)
    assert config["ntt_config"]["modmul"] == "solinas"
    assert int(config["modulus_hex"], 16) == config["modulus"]
    assert [m["name"] for m in spec.metrics_for(BENCH, CELL, trace=False)] == [
        "ntt_per_s", "setup_s"]
    assert {m["name"] for m in spec.metrics_for(BENCH, CELL, trace=True)} >= {
        "build_s", "solinas_roofline.goldilocks", "ntt_roofline.goldilocks",
        "device_idle.goldilocks", "launches.goldilocks", "enqueue_ms.goldilocks"}


def small(system=None):
    result, _ = harness.run_cell(BENCH, CELL, 2**31 + 11, 0.2, False, device="cpu",
                                 system=system, n=1024)
    return result


def test_a_small_run_of_the_cell_is_correct():
    r = small()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["outputs_compared"]["value"] >= 1
    assert set(r["metrics"]) == {"ntt_per_s", "setup_s"}


def test_the_control_is_not_correct_on_goldilocks():
    r = small(harness.ControlSystem)
    assert not r["correct"]
    wrong = {k: v["value"] for k, v in r["checks"].items() if k.endswith("_wrong_words")}
    assert wrong and all(v > 0 for v in wrong.values()), wrong
