"""The yardstick's arithmetic and the reading of a trace, on synthetic data."""

import statistics

import pytest

from bench_port import devtrace, yardstick


def test_roofline_bytes():
    assert yardstick.transform_bytes(1 << 24) == 16 << 24
    assert yardstick.transform_bytes(1 << 17) == 16 << 17
    assert yardstick.pointwise_bytes(8) == 192
    assert yardstick.polymul_bytes(1 << 24) == 72 << 24
    # a 2^24 transform's least time at 3.35 TB/s: 0.0801 ms
    assert yardstick.least_seconds(yardstick.transform_bytes(1 << 24)) == pytest.approx(
        8.0130e-5, rel=1e-4)


def test_percentile_takes_every_sample():
    values = list(range(1, 101))
    assert yardstick.percentile(values, 95) == 95
    assert yardstick.percentile(values[::-1], 95) == 95
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile([3, 1, 2], 100) == 3
    assert yardstick.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_busy_and_idle_from_a_timeline():
    # kernels at [1, 3), [2, 4) overlapping, [6, 7), one partly outside [0, 10)
    ops = [(1, 3), (2, 4), (6, 7), (9, 12)]
    assert yardstick.merge(ops, 0, 10) == [(1, 4), (6, 7), (9, 10)]
    assert yardstick.busy_seconds(ops, 0, 10) == 5
    assert yardstick.idle_gaps(ops, 0, 10) == [(0, 1), (4, 6), (7, 9)]
    assert yardstick.busy_seconds([], 0, 10) == 0
    assert yardstick.idle_gaps([(0, 10)], 0, 10) == []


def test_quartile_spread_rule():
    """The bound's spread: the distance between statistics.quantiles'
    quartiles as a share of the median."""
    q1, _, q3 = statistics.quantiles([100, 101, 102, 103, 104, 105], n=4)
    assert (q3 - q1) / statistics.median([100, 101, 102, 103, 104, 105]) == pytest.approx(
        3.5 / 102.5)


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic():
    # microseconds: the window [1000, 2000), two calls; a kernel before it
    return [
        event("bench.window", "user_annotation", 1000, 1000),
        event("bench.window", "gpu_user_annotation", 1000, 1000),
        event("bench.forward", "user_annotation", 1000, 200),
        event("aten::reshape", "cpu_op", 1010, 150),
        event("bench.forward", "user_annotation", 1500, 100),
        event("cudaLaunchKernel", "cuda_runtime", 1520, 10),
        event("bench.wait", "user_annotation", 1600, 390),
        event("cudaEventSynchronize", "cuda_runtime", 1600, 390),
        event("kernel_a", "kernel", 900, 50),
        event("kernel_a", "kernel", 1200, 200),
        event("kernel_b", "kernel", 1400, 100),
        event("at::native::add_kernel", "kernel", 1600, 300),
        event("Memset (Device)", "gpu_memset", 1950, 10),
        {"ph": "i", "name": "marker", "ts": 1300},
    ]


def test_trace_reading():
    tr = devtrace.parse(synthetic())
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(610e-6)
    assert tr.idle_percent() == pytest.approx(39.0)
    assert tr.device_seconds() == pytest.approx(610e-6)
    assert tr.device_seconds(lambda n: "at::native" in n) == pytest.approx(300e-6)
    b = tr.breakdown()
    assert [k for k, _ in b["device_ops"]] == [
        "at::native::add_kernel", "kernel_a", "kernel_b", "Memset (Device)"]
    gaps = dict(b["idle_gaps"])
    # [1000, 1200) while the host reshaped inside the first call, [1900,
    # 1950) and [1960, 2000) waiting on the last event
    assert gaps["bench.forward / aten::reshape"] == pytest.approx(200e-6)
    assert gaps["bench.wait / cudaEventSynchronize"] == pytest.approx(90e-6)
    assert sum(gaps.values()) == pytest.approx(390e-6)


def test_trace_needs_one_window():
    with pytest.raises(ValueError):
        devtrace.parse([e for e in synthetic() if e["name"] != "bench.window"])
