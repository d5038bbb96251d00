"""The reader of the pointwise kernel's device time, on a synthetic trace
with answers worked out by hand."""

import types

import pytest

from bench_port import devtrace, spec


def kernel(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur}


def trace(kernels, products=2):
    # microseconds: the window [1000, 3000)
    events = [{"ph": "X", "name": "bench.window", "cat": "user_annotation", "ts": 1000,
               "dur": 2000}, *kernels]
    tr = devtrace.parse(events)
    tr.work = {"products": products}
    return tr


def read(tr):
    run = types.SimpleNamespace(window=types.SimpleNamespace(trace=tr))
    return spec.reader("pointwise_kernel_ms.polymul")(run)


TRANSFORM = "void (anonymous namespace)::mxu_tc_kernel<false, 0, 1, false, false>(...)"
POINTWISE = "void (anonymous namespace)::pointwise_mont_mul_kernel<false>(long long const*, ...)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<2, at::native::AUnaryFunctor<...>>"


def test_it_reads_the_named_kernels_device_ms_per_product():
    tr = trace([kernel(TRANSFORM, 1000, 400), kernel(POINTWISE, 1400, 130),
                kernel(TRANSFORM, 1600, 400), kernel(POINTWISE, 2100, 150),
                kernel(ELEMENTWISE, 2300, 90)])
    # 130 + 150 us over 2 products; the transforms and PyTorch's kernel left out
    assert read(tr) == pytest.approx(0.140)


def test_a_kernel_cut_by_the_window_counts_its_part_inside():
    tr = trace([kernel(POINTWISE, 2950, 100)], products=1)
    assert read(tr) == pytest.approx(0.050)


@pytest.mark.parametrize("kernels,products", [
    ([kernel(TRANSFORM, 1000, 400), kernel(ELEMENTWISE, 1500, 100)], 2),  # PyTorch's step
    ([kernel(POINTWISE, 1400, 130)], 0),  # no product in the traced part
    ([], 2),
], ids=["plain-step", "no-products", "empty"])
def test_nothing_to_read_without_the_kernel(kernels, products):
    assert read(trace(kernels, products)) is None


def test_nothing_to_read_in_an_untraced_run():
    assert read(None) is None
