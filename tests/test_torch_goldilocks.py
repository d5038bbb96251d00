"""PyTorch port on the Goldilocks field, N = 2^64 - 2^32 + 1, g = 7, under
the Solinas multiply (``modmul="solinas"``), as the benchmark's
``goldilocks-2p24`` configuration runs it.

* the port's ``NTT`` against the benchmark's plain reference
  (``bench_port/reference/ntt.py``), bit for bit in both directions: the
  butterfly engine with its three levels, (16 x 16) x 16 at 2^12 as the
  2^24 plan's (256 x 256) x 256, a batched input, and the configuration
  file itself with only ``n`` made small;
* the reference against a DFT in Python integers at n = 64, with its
  root of exact order n;
* ``ntt_pallas.MODMUL`` has the C entry's multiplies as its keys; that
  each launch, walked and replayed, counts under its configuration's
  multiply is ``tests/test_torch_launch_program.py``'s (on a made-up
  card), and the kernels' values on the card are ``chip_smoke.py``'s.
"""

import json
import os

import pytest
import torch

from sventt_tpu_torch.field.golden import bitreverse
from sventt_tpu_torch.field.modulus import GOLDILOCKS_MODULUS
from sventt_tpu_torch.ops import ntt_pallas
from sventt_tpu_torch.plan import NTT, NttConfig, planner, wrapper

from bench_port.reference.ntt import ReferenceNTT
from bench_port.systems.ntt import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bench_port", "configs", "goldilocks-2p24.json")) as f:
    CONFIG = json.load(f)
N, G = CONFIG["modulus"], CONFIG["generator"]
#: The three levels of the 2^24 plan, at 2^12.
THREE_LEVELS = dict(engine="pallas", modmul="solinas", max_fused=16)


def data(shape, seed):
    """Uniform words below N, N - 1 among them."""
    g = torch.Generator().manual_seed(seed)
    hi = torch.randint(0, 1 << 32, shape, generator=g, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, shape, generator=g, dtype=torch.int64)
    x = (hi % 0xFFFF_FFFF) << 32 | lo  # hi < 2^32 - 1: every word below N
    x.view(-1)[1] = N - 1 - (1 << 64)  # N - 1 as an int64 bit pattern
    return x


def test_the_configuration_is_goldilocks():
    assert N == GOLDILOCKS_MODULUS == int(CONFIG["modulus_hex"], 16) == 2**64 - 2**32 + 1
    assert (N - 1) % CONFIG["n"] == 0 and CONFIG["n"] == 1 << 24
    # 7 generates: a non-residue, so its (N - 1) / 2^32-th power has order 2^32
    assert pow(G, (N - 1) // 2, N) == N - 1


@pytest.mark.parametrize("shape", [(1 << 12,), (1 << 12, 3)], ids=["2^12", "2^12-batch-3"])
def test_three_levels_equal_the_reference(shape):
    n = shape[0]
    ntt = NTT(NttConfig(N, G, n, **THREE_LEVELS), device="cpu")
    assert ntt.fc.modmul == "solinas" and not ntt.fc.lazy
    plan = ntt.plan
    assert isinstance(plan, planner.Split) and isinstance(plan.col, planner.Split)
    assert (plan.m1, plan.col.m0, plan.col.m1) == (16, 16, 16)
    ref = ReferenceNTT(N, G, n, "cpu")
    x, y = data(shape, 1), data(shape, 2)
    ntt_pallas.reset_counts()
    fx = ntt.compute_forward(x)
    assert torch.equal(fx, ref.forward(x))
    assert torch.equal(ntt.compute_inverse(y), ref.inverse(y))
    assert torch.equal(ntt.compute_inverse(fx), x)
    # K4 leaf, K5 mid and the K6 lane root; a batch's root row runs on the mid axis
    plain = ntt_pallas.PLAIN_CALLS
    assert plain["leaf"] > 0 and plain["mid"] > 0, plain
    assert (plain["lane"] > 0) == (len(shape) == 1), plain


@pytest.mark.parametrize("card_rule", [False, True], ids=["cpu-auto", "card-auto"])
def test_the_configuration_file_runs_as_the_benchmark_builds_it(monkeypatch, card_rule):
    """The file with only ``n`` made small, through the benchmark's own
    system; "auto" as the CPU resolves it (the matrix engine) and as the
    card does (the butterfly engine)."""
    if card_rule:
        rule = wrapper._resolve_engine
        monkeypatch.setattr(wrapper, "_resolve_engine",
                            lambda config, device: rule(config, "cuda"))
    n = 1 << 10
    system = System({**CONFIG, "n": n}, {"op": "roundtrip"}, "cpu", 1)
    assert system.ntt.fc.modmul == "solinas"
    assert system.ntt.engine == ("pallas" if card_rule else "mxu")
    ref = ReferenceNTT(N, G, n, "cpu")
    x = data((n,), 3)
    fx = system.forward(x)
    assert torch.equal(fx, ref.forward(x))
    assert torch.equal(system.inverse(fx), x)
    assert torch.equal(system.inverse(x), ref.inverse(x))


def test_the_reference_is_the_dft():
    n = 64
    w = pow(G, (N - 1) // n, N)
    assert pow(w, n, N) == 1 and pow(w, n // 2, N) == N - 1  # exact order n
    ref = ReferenceNTT(N, G, n, "cpu")
    bits = n.bit_length() - 1
    x = data((n,), 4)
    xs = [v % (1 << 64) for v in x.tolist()]
    got = [v % (1 << 64) for v in ref.forward(x).tolist()]
    assert got == [sum(xs[j] * pow(w, j * bitreverse(p, bits), N) for j in range(n)) % N
                   for p in range(n)]
    w_inv, n_inv = pow(w, -1, N), pow(n, -1, N)
    got = [v % (1 << 64) for v in ref.inverse(x).tolist()]
    assert got == [n_inv * sum(xs[p] * pow(w_inv, j * bitreverse(p, bits), N)
                               for p in range(n)) % N for j in range(n)]


def test_the_counter_has_the_c_entrys_multiplies():
    assert list(ntt_pallas.MODMUL) == list(ntt_pallas._MODMUL)
