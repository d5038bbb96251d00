"""The seeded generator and the caller's bookkeeping, on the CPU."""

import pytest
import torch

from bench_port import spec, traffic

FLAGSHIP = 0xFFFF_FC6E_8000_0001
MIXES = ["roundtrip", "polymul", "sync"]


def config(n):
    return {"n": n, "modulus": FLAGSHIP}


def unsigned(t: torch.Tensor) -> list[int]:
    return [int(v) % (1 << 64) for v in t.reshape(-1)]


@pytest.mark.parametrize("name", MIXES)
def test_inputs_repeat_for_a_seed_and_differ_across_seeds(name):
    mix = spec.load_traffic(name)
    seed = 2**31 + 977  # seeds may pass 32 signed bits
    a = traffic.make_inputs(mix, config(256), seed, "cpu")
    b = traffic.make_inputs(mix, config(256), seed, "cpu")
    c = traffic.make_inputs(mix, config(256), seed + 1, "cpu")
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])
        assert a[k].shape[0] == traffic.RING


@pytest.mark.parametrize("name", MIXES)
def test_inputs_are_residues_with_the_mix_layout(name):
    mix = spec.load_traffic(name)
    n = 512
    inputs = traffic.make_inputs(mix, config(n), 11, "cpu")
    for t in inputs.values():
        assert all(v < FLAGSHIP for v in unsigned(t))
    if mix["op"] == "polymul":
        fill = int(n * mix["coefficients"])
        for t in inputs.values():
            assert t.shape == (traffic.RING, n)
            assert not t[:, fill:].any()
            assert (t[:, :fill] != 0).float().mean() > 0.99
        assert not torch.equal(inputs["a"], inputs["b"])
    else:
        assert inputs["x"].shape == (traffic.RING, n)
        assert len(set(unsigned(inputs["x"]))) == inputs["x"].numel()


def test_words_fill_all_64_bits():
    gen = torch.Generator().manual_seed(3)
    v = unsigned(traffic.residues((4096,), FLAGSHIP, gen, "cpu"))
    assert max(v) > 1 << 63 and min(v) < 1 << 54


def test_reservoir_is_uniform_and_seeded():
    counts = [0] * 20
    for seed in range(2000):
        r = traffic.Reservoir(4, seed)
        for item in range(20):
            r.offer(item)
        for item in r.items:
            counts[item] += 1
    assert sum(counts) == 8000
    assert min(counts) > 300 and max(counts) < 500  # 400 each
    a, b = traffic.Reservoir(3, 9), traffic.Reservoir(3, 9)
    for item in range(50):
        a.offer(item)
        b.offer(item)
    assert a.items == b.items


class Echo:
    """A system that returns its input: the caller's counts only."""

    def forward(self, x):
        return x.clone()

    inverse = forward

    def polymul(self, a, b):
        return a.clone()


@pytest.mark.parametrize("name", MIXES)
def test_a_unit_counts_its_work(name):
    mix = spec.load_traffic(name)
    per_unit = {"roundtrip": ("transforms", 2), "sync": ("transforms", 1),
                "polymul": ("products", 1)}[name]
    inputs = traffic.make_inputs(mix, config(64), 1, "cpu")
    caller = traffic.Caller(Echo(), mix, inputs, "cpu")
    w = caller.run(calls=12, sample_seed=1)
    units = 12 // caller.unit_calls
    assert (w.calls, w.failed) == (12, 0)
    assert w.work == {per_unit[0]: units * per_unit[1]}
    assert len(w.host_call_s) == 12
    assert len(w.latency_ms) == (12 if mix.get("sync") else 0)
    assert len(w.samples) == min(traffic.SAMPLES, units)
    for i, outputs in w.samples:
        assert 0 <= i < traffic.RING and len(outputs) == caller.unit_calls


def test_a_roundtrip_pairs_a_forward_with_the_inverse_of_its_output():
    mix = spec.load_traffic("roundtrip")
    inputs = traffic.make_inputs(mix, config(64), 2, "cpu")
    w = traffic.Caller(Echo(), mix, inputs, "cpu").run(calls=16, sample_seed=2)
    for i, (y, z) in w.samples:
        assert torch.equal(y, inputs["x"][i]) and torch.equal(z, y)


def test_a_failed_call_is_counted():
    class Broken(Echo):
        def forward(self, x):
            raise RuntimeError("boom")

    mix = spec.load_traffic("sync")
    inputs = traffic.make_inputs(mix, config(64), 1, "cpu")
    w = traffic.Caller(Broken(), mix, inputs, "cpu").run(calls=5, sample_seed=1)
    assert (w.calls, w.failed, w.work, w.samples) == (5, 5, {}, [])


def test_a_failed_forward_fails_the_rest_of_its_pair():
    class Broken(Echo):
        def forward(self, x):
            raise RuntimeError("boom")

    mix = spec.load_traffic("roundtrip")
    inputs = traffic.make_inputs(mix, config(64), 1, "cpu")
    w = traffic.Caller(Broken(), mix, inputs, "cpu").run(calls=6, sample_seed=1)
    assert (w.calls, w.failed, w.work, w.samples) == (6, 6, {}, [])


def test_the_window_runs_its_seconds():
    mix = spec.load_traffic("roundtrip")
    inputs = traffic.make_inputs(mix, config(64), 1, "cpu")
    w = traffic.Caller(Echo(), mix, inputs, "cpu").run(seconds=0.2, sample_seed=1)
    assert 0.2 <= w.seconds < 1.0 and w.calls > 10
