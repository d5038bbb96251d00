"""PyTorch port, the flagship at n = 2^28 as the benchmark's
``flagship-2p28`` configuration runs it: ``NTT(NttConfig(N, g, 2^28))``
with every knob at its default.

* "auto"'s plan on a card is four levels of 128, ((128 x 128) x 128) x
  128: the K4 leaf, the K5 mid at two depths and the K6 lane root;
* the same four-level shape at 2^12 (leaves of 8: ``AUTO_MAX_FUSED``
  lowered), its root made companion-free as 2^28's is (``W_ONLY_THRESHOLD``
  lowered to n), through the butterfly engine's plain versions: word for
  word the benchmark's plain reference (``bench_port/reference/ntt.py``)
  and ``GoldenNTT``, with an exact roundtrip;
* ``ntt_pallas.TWIDDLE`` on a made-up card (``test_torch_launch_program``'s):
  that small call's launches, and the 2^28 and 2^24 plans' with their
  device-built inter-step tables allocated and left unwritten -- one "w"
  launch a direction at 2^28, the K6 root's, and none at 2^24, whose root
  reads a pair table.

The kernels' values at 2^28 are checked on the card (``chip_smoke.py``).
"""

import json
import os

import pytest
import torch
from test_torch_launch_program import card  # noqa: F401  (the made-up card)

from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS
from sventt_tpu_torch.ops import ntt_pallas
from sventt_tpu_torch.ops.twiddle import MontPair
from sventt_tpu_torch.plan import NTT, NttConfig, planner, wrapper

from bench_port.reference.ntt import ReferenceNTT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "bench_port", "configs", "flagship-2p28.json")) as f:
    CONFIG = json.load(f)
N, G = CONFIG["modulus"], CONFIG["generator"]
#: The small size and leaf of the four-level shape.
SMALL, LEAF = 1 << 12, 8


def four_levels(n: int, m: int) -> planner.Split:
    """((m x m) x m) x m of n = m^4 points, every leaf pallas."""
    L = planner.Leaf
    return planner.Split(n, n // m, m, planner.Split(
        n // m, n // m**2, m, planner.Split(m * m, m, m, L(m, "pallas"), L(m, "pallas")),
        L(m, "pallas")), L(m, "pallas"))


def four_levels_at_2p12(monkeypatch) -> None:
    """"auto" plans 2^12 as ((8 x 8) x 8) x 8, its root's table
    companion-free, as it plans 2^28 in 128s."""
    monkeypatch.setattr(wrapper, "AUTO_MAX_FUSED", LEAF)
    monkeypatch.setattr(planner, "W_ONLY_THRESHOLD", SMALL)


def data(n: int, seed: int) -> torch.Tensor:
    """Uniform words below N, N - 1 among them."""
    g = torch.Generator().manual_seed(seed)
    hi = torch.randint(0, N >> 32, (n,), generator=g, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, (n,), generator=g, dtype=torch.int64)
    x = (hi << 32) | lo  # hi < N >> 32: every word below N
    x[1] = N - 1 - (1 << 64)  # N - 1 as an int64 bit pattern
    return x


def test_the_configuration_is_the_flagship_at_2p28():
    assert (N, G) == (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR) == (
        int(CONFIG["modulus_hex"], 16), 3)
    assert CONFIG["n"] == 1 << 28 and (N - 1) % CONFIG["n"] == 0
    assert CONFIG["ntt_config"] == {"engine": "auto", "modmul": "auto"}
    assert CONFIG["ntt_options"] == {}


def test_auto_plan_on_a_card_is_four_levels_of_128():
    """Leaves of up to ``AUTO_MAX_FUSED`` = 512 cut 28 stages into four of
    7, where 2^24 takes three of 8."""
    cfg = NttConfig(N, G, CONFIG["n"], **CONFIG["ntt_config"])
    plan = wrapper.build_config_plan(cfg, wrapper._resolve_engine(cfg, "cuda"))
    L = planner.Leaf
    assert plan == four_levels(1 << 28, 128) == planner.Split(
        1 << 28, 1 << 21, 128, planner.Split(
            1 << 21, 1 << 14, 128,
            planner.Split(1 << 14, 128, 128, L(128, "pallas"), L(128, "pallas")),
            L(128, "pallas")), L(128, "pallas"))


@pytest.fixture
def small(monkeypatch):
    """The four-level shape at 2^12 on the plain versions, "auto" resolved
    as on a card, its root's table companion-free and the inner levels'
    pairs, as at 2^28."""
    rule = wrapper._resolve_engine
    monkeypatch.setattr(wrapper, "_resolve_engine", lambda config, device: rule(config, "cuda"))
    four_levels_at_2p12(monkeypatch)
    ntt = NTT(NttConfig(N, G, SMALL), device="cpu")
    assert ntt.engine == "pallas" and ntt.plan == four_levels(SMALL, LEAF)
    for tables in (ntt._fwd_tables, ntt._inv_tables):
        companions = {k: tw.wp is not None for k, tw in tables.split_tw.items()}
        assert companions == {(512, 8): False, (64, 8): True, (8, 8): True}
    return ntt


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_four_levels_equal_the_reference(small, inverse):
    x = data(SMALL, 28 + inverse)
    ntt_pallas.reset_counts()
    got = (small.compute_inverse if inverse else small.compute_forward)(x)
    assert ntt_pallas.PLAIN_CALLS == {"leaf": 1, "mid": 2, "lane": 1, "grouped": 0,
                                      "lane_grouped": 0}
    ref = ReferenceNTT(N, G, SMALL, "cpu")
    assert torch.equal(got, (ref.inverse if inverse else ref.forward)(x))
    golden = GoldenNTT(SMALL, small.mod)
    words = [v % (1 << 64) for v in x.tolist()]
    want = golden.inverse(words) if inverse else golden.forward(words)
    assert [v % (1 << 64) for v in got.tolist()] == want


def test_four_levels_roundtrip_exactly(small):
    x = data(SMALL, 2028)
    assert torch.equal(small.compute_inverse(small.compute_forward(x)), x)


def unwritten_twiddles(mod, n0, n1, *, with_companion=True, modmul="montgomery", **_):
    """``sixstep_row_twiddles_device``'s tables, allocated and left
    unwritten: the made-up card computes nothing."""
    def table():
        return torch.empty((n0, n1), dtype=torch.int64)
    return MontPair(table(), table() if with_companion and modmul != "solinas" else None)


#: (id, n, the small shape, each launch's ``TWIDDLE`` key in forward run order)
TWIDDLE_CASES = [
    ("2^28", 1 << 28, False, ("none", "pair", "pair", "w")),
    ("2^24", 1 << 24, False, ("none", "pair", "pair")),
    ("2^12-four-levels", SMALL, True, ("none", "pair", "pair", "w")),
]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n,small_shape,forms", [c[1:] for c in TWIDDLE_CASES],
                         ids=[c[0] for c in TWIDDLE_CASES])
def test_the_root_alone_reads_a_companion_free_table(card, monkeypatch, n, small_shape, forms,
                                                     inverse):
    """The call that builds the launch program and its replay each count
    every launch once under its inter-step twiddle's form: the K4 leaf
    none, each K5 mid a pair, the K6 root a pair below
    ``W_ONLY_THRESHOLD`` (2^24) and "w" at or above it (2^28), the root's
    launch last on the forward and first on the inverse."""
    if small_shape:
        four_levels_at_2p12(monkeypatch)
    monkeypatch.setattr(planner, "sixstep_row_twiddles_device", unwritten_twiddles)
    ntt = NTT(NttConfig(N, G, n), enable_forward=not inverse, enable_inverse=inverse,
              device="cpu")
    call = ntt.compute_inverse if inverse else ntt.compute_forward
    order = forms[::-1] if inverse else forms
    x = torch.empty(n, dtype=torch.int64)
    want = {k: order.count(k) for k in ntt_pallas.TWIDDLE}
    for i in range(2):
        ntt_pallas.reset_counts()
        call(x)
        assert len(card.take()) == len(order)
        assert ntt_pallas.TWIDDLE == want, i
        assert ntt_pallas.PROGRAMS == {"built": int(i == 0), "replayed": int(i > 0)}
    program = ntt._programs[(inverse, (n,), (1,))]
    assert tuple(launch.twiddle for launch in program.launches) == order
