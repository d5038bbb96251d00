"""The reader of the K6 lane root's share of its roofline
(``lane_roofline.2p28``), on a synthetic trace with answers worked out by
hand, and the flagship 2^28 cell at a small size on the CPU."""

import types

import pytest

from bench_port import devtrace, harness, lane_bytes, spec, yardstick

BENCH = spec.load_benchmark()
CELL = "flagship-2p28.roundtrip"


def kernel(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur}


def trace(kernels, transforms=2, window=2000):
    # microseconds: the window [1000, 1000 + window)
    events = [{"ph": "X", "name": "bench.window", "cat": "user_annotation", "ts": 1000,
               "dur": window}, *kernels]
    tr = devtrace.parse(events)
    tr.work = {"transforms": transforms}
    return tr


def read(metric, tr, n=1 << 28):
    run = types.SimpleNamespace(n=n, window=types.SimpleNamespace(trace=tr))
    return spec.reader(metric)(run)


def reg(inv, mm, lane=False, rmax=4):
    """The demangled name of a radix-2 register-kernel instantiation."""
    b = lambda v: "true" if v else "false"
    return (f"void (anonymous namespace)::radix2_reg_kernel<{b(inv)}, {mm}, false, {rmax}, "
            f"{b(not lane)}, {b(lane)}>((anonymous namespace)::R2Args)")


MXU = "void (anonymous namespace)::mxu_tc_kernel<false, 0, 1, false, true>(...)"


def test_only_the_lane_instantiations_count():
    tr = trace([kernel(reg(False, 0), 1000, 300), kernel(reg(False, 0, lane=True), 1300, 120),
                kernel(reg(True, 0, lane=True), 1420, 180), kernel(reg(True, 0), 1600, 250),
                kernel(MXU, 1850, 100)])
    n = 1 << 20
    least = 2 * yardstick.transform_bytes(n) / yardstick.HBM_BYTES_PER_S
    # 120 + 180 us of LANE = true; the leaf / mid kernels and the matrix
    # kernel (whose last template argument is true too) left out
    assert read("lane_roofline.2p28", tr, n) == pytest.approx(100 * least / 300e-6)


def test_four_levels_by_hand():
    """Two transforms of 2^28 words: 2 x 2^32 bytes at 3.35 TB/s is
    2.5643 ms; the two K6 launches take 6 ms (42.7%), all six 30 ms
    (8.5%)."""
    tr = trace([kernel(reg(False, 0), 1000, 4000), kernel(reg(False, 0), 5000, 4000),
                kernel(reg(False, 0), 9000, 4000), kernel(reg(False, 0, lane=True), 13000, 3000),
                kernel(reg(True, 0, lane=True), 16000, 3000), kernel(reg(True, 0), 19000, 12000)],
               window=31000)
    assert lane_bytes.root_seconds(1 << 28, 2) == pytest.approx(2.5643e-3, rel=1e-4)
    assert read("lane_roofline.2p28", tr) == pytest.approx(100 * 2.5643e-3 / 6e-3, rel=1e-4)
    assert read("ntt_roofline.2p28", tr) == pytest.approx(100 * 2.5643e-3 / 30e-3, rel=1e-4)


@pytest.mark.parametrize("name,lane", [
    (reg(False, 0, lane=True), True), (reg(True, 0, lane=True), True),
    (reg(False, 2, lane=True), True), (reg(True, 1, lane=True, rmax=3), True),
    ("void (anonymous namespace)::radix2_reg_kernel<false,0,false,3,true,true>(...)", True),
    (reg(False, 0), False), (reg(True, 2), False), (MXU, False),
    ("void (anonymous namespace)::grouped_reg_kernel<false, 0, false, true>(...)", False),
    ("void (anonymous namespace)::radix2_reg_kernel<false, 0, false, 4, true, trueish>(...)",
     False),
], ids=["fwd", "inv", "solinas", "shoup-r3", "unspaced", "leaf", "solinas-leaf", "mxu",
        "grouped", "trueish"])
def test_the_name_rule(name, lane):
    assert lane_bytes.is_lane(name) == lane


@pytest.mark.parametrize("kernels,transforms", [
    ([kernel(reg(False, 0), 1000, 400), kernel(MXU, 1500, 100)], 2),  # no lane kernel
    ([kernel(reg(False, 2), 1000, 400), kernel(reg(True, 2), 1500, 300)], 2),  # Solinas leaves
    ([kernel(reg(False, 0, lane=True), 1000, 400)], 0),  # no transform in the traced part
    ([], 2),
], ids=["leaf-only", "solinas-leaf-only", "no-transforms", "empty"])
def test_nothing_to_read_without_a_lane_kernel(kernels, transforms):
    assert read("lane_roofline.2p28", trace(kernels, transforms)) is None


def test_nothing_to_read_in_an_untraced_run():
    assert read("lane_roofline.2p28", None) is None


def test_it_is_at_least_the_ntt_roofline():
    """The root's bytes are a transform's, over a part of its time."""
    tr = trace([kernel(reg(False, 0), 1000, 280), kernel(reg(False, 0), 1300, 330),
                kernel(reg(False, 0, lane=True), 1650, 360),
                kernel(reg(True, 0, lane=True), 2050, 430)], transforms=2)
    whole, lane = read("ntt_roofline.2p28", tr), read("lane_roofline.2p28", tr)
    assert whole is not None and lane == pytest.approx(whole * 1400 / 790)


def test_the_cell_names_its_configuration_and_metrics():
    w = spec.workload(BENCH, CELL)
    assert w["chips"] == 1 and w["traffic"] == "roundtrip"
    config = spec.load_config(BENCH, w["config"])
    assert (config["modulus"], config["generator"], config["n"]) == (
        0xFFFF_FC6E_8000_0001, 3, 1 << 28)
    assert int(config["modulus_hex"], 16) == config["modulus"]
    assert [m["name"] for m in spec.metrics_for(BENCH, CELL, trace=False)] == [
        "ntt_per_s", "setup_s"]
    assert {m["name"] for m in spec.metrics_for(BENCH, CELL, trace=True)} == {
        "build_s", "ntt_roofline.2p28", "device_idle.2p28", "launches.2p28",
        "enqueue_ms.2p28", "lane_roofline.2p28"}


def small(system=None):
    result, _ = harness.run_cell(BENCH, CELL, 2**31 + 28, 0.2, False, device="cpu",
                                 system=system, n=1024)
    return result


def test_a_small_run_of_the_cell_is_correct():
    r = small()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["outputs_compared"]["value"] >= 1
    assert set(r["metrics"]) == {"ntt_per_s", "setup_s"}


def test_the_control_is_not_correct_at_a_small_size():
    r = small(harness.ControlSystem)
    assert not r["correct"]
    wrong = {k: v["value"] for k, v in r["checks"].items() if k.endswith("_wrong_words")}
    assert wrong and all(v > 0 for v in wrong.values()), wrong
