"""The readers of the program's spans, on a synthetic trace with answers
worked out by hand."""

import types

import pytest

from bench_port import devtrace, spec


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def ua(name, ts, dur):
    return event(name, "user_annotation", ts, dur)


def rt(name, ts, dur):
    return event(name, "cuda_runtime", ts, dur)


def synthetic():
    # microseconds: the window [1000, 3000), two calls into the program
    return [
        ua("bench.window", 1000, 2000),
        # call 1, [1000, 1600): a product, its two forwards, its pointwise
        # step and its inverse nested inside it
        ua("bench.polymul", 1000, 600),
        ua("sventt.convolve", 1000, 600),
        ua("sventt.forward", 1010, 90),
        ua("sventt.launch.tensor_core", 1050, 30),
        rt("cudaLaunchKernel", 1060, 10),
        event("cuLaunchKernel", "cuda_driver", 1062, 6),  # the same launch
        ua("sventt.forward", 1110, 90),
        ua("sventt.launch.tensor_core", 1150, 20),
        rt("cudaLaunchKernel", 1155, 5),
        ua("sventt.convolve.pointwise", 1210, 90),
        rt("cudaLaunchKernel", 1220, 5),
        rt("cudaLaunchKernel", 1240, 5),
        rt("cudaLaunchKernel", 1260, 5),
        ua("sventt.inverse", 1310, 280),
        ua("sventt.launch.tensor_core", 1400, 50),
        rt("cudaLaunchKernel", 1410, 5),
        # between the calls: a launch outside them
        rt("cudaLaunchKernel", 1700, 5),
        # call 2, [2000, 2200): a forward whose launch spans nest
        ua("bench.forward", 2000, 200),
        ua("sventt.forward", 2000, 200),
        ua("sventt.launch.fused", 2050, 110),
        ua("sventt.launch.tensor_core", 2100, 50),
        rt("cudaLaunchKernel", 2120, 5),
        # a launch span outside every call
        ua("sventt.launch.inter_step", 2500, 100),
        # the device: busy [1000, 1050), [1100, 1500), [2180, 2300), [2900, 3000)
        event("kernel_a", "kernel", 1000, 50),
        event("kernel_b", "kernel", 1100, 400),
        event("kernel_a", "kernel", 2180, 120),
        event("kernel_c", "kernel", 2900, 100),
    ]


def read(metric, trace):
    run = types.SimpleNamespace(window=types.SimpleNamespace(trace=trace))
    return spec.reader(metric)(run)


def test_the_span_readers():
    tr = devtrace.parse(synthetic())
    # calls: [1000, 1600) and [2000, 2200), 800 us; launch spans inside
    # them 30 + 20 + 50 + 110 (the nested ones once) = 210 us
    assert read("launch_host_ms.sync", tr) == pytest.approx(0.105)
    assert read("plan_host_ms.sync", tr) == pytest.approx(0.295)
    assert read("plan_host_ms.sync.2p17", tr) + read("launch_host_ms.sync.2p17", tr) == (
        pytest.approx(0.4))
    # 6 launches in call 1 (cuLaunchKernel under cudaLaunchKernel is one), 1 in
    # call 2, the one between the calls not counted
    assert read("launches.stream", tr) == pytest.approx(3.5)
    assert read("launches.sync.2p17", tr) == pytest.approx(3.5)
    assert read("pointwise_launches.polymul", tr) == pytest.approx(3.0)
    # idle [1050, 1100), [1500, 2180), [2300, 2900); inside the calls 50 +
    # 100 + 180 = 330 us of the window's 2000
    assert read("idle_in_call.sync", tr) == pytest.approx(16.5)
    assert read("idle_in_call.sync.2p17", tr) == pytest.approx(16.5)


def test_an_idle_gap_is_put_down_to_the_programs_span():
    gaps = dict(devtrace.parse(synthetic()).breakdown()["idle_gaps"])
    assert gaps["bench.polymul / sventt.launch.tensor_core"] == pytest.approx(50e-6)


@pytest.mark.parametrize("metric", ["plan_host_ms.sync", "launch_host_ms.sync",
                                    "launches.stream", "pointwise_launches.polymul",
                                    "idle_in_call.sync"])
def test_nothing_to_read_without_the_programs_spans(metric):
    """A program that records no spans, or an untraced run."""
    bare = [e for e in synthetic() if not e["name"].startswith("sventt.")]
    assert read(metric, devtrace.parse(bare)) is None
    assert read(metric, None) is None


def test_a_trace_of_forwards_has_no_pointwise_step():
    fwd = [e for e in synthetic() if e["name"] not in ("sventt.convolve",
                                                       "sventt.convolve.pointwise")]
    tr = devtrace.parse(fwd)
    assert read("pointwise_launches.polymul", tr) is None
    # now four calls: three forwards and the inverse; the pointwise step's
    # three launches lie outside them
    assert read("launches.stream", tr) == pytest.approx(4 / 4)
