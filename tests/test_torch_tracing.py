"""The port's spans (``sventt_tpu_torch.utils.profiling.span``): what a
profiler sees of a call, of a product and of ``NTT(...)``, on small CPU
plans; that no span is recorded without a profiler; that a traced call
gives the untraced call's output bit for bit."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sventt_tpu_torch import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, NTT, NttConfig
from sventt_tpu_torch.apps.convolve import cyclic_convolve
from sventt_tpu_torch.plan import planner
from sventt_tpu_torch.utils import profiling

N = 1 << 12
ENGINES = ["mxu", "pallas"]


def residues(seed):
    """N words below 2^63, so below the flagship modulus."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, (1 << 63) - 1, (N,), generator=gen, dtype=torch.int64)


def config(engine, **kw):
    # 4096 = (16 x 16) x 16: the root's row, the inner row, the column leaf
    return NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, N, engine=engine, max_fused=16, **kw)


def recorded(fn):
    """fn's result and the sventt spans a CPU profiler recorded, as
    [(name, start, end)] in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("sventt.")), key=lambda s: (s[1], -s[2]))
    return out, spans


def inside(spans, outer):
    """The spans that lie within ``outer`` (itself excluded)."""
    _, lo, hi = outer
    return [s for s in spans if lo <= s[1] and s[2] <= hi and s != outer]


def direct(spans, outer):
    """Names of the spans directly inside ``outer``, in order."""
    within = inside(spans, outer)
    return [s[0] for s in within if not any(s in inside(within, o) for o in within)]


@pytest.fixture(scope="module", params=ENGINES)
def ntt(request):
    return NTT(config(request.param), device="cpu")


@pytest.fixture(scope="module")
def x():
    return residues(3)


def calls(spans, name):
    return [s for s in spans if s[0] == name]


def test_a_forward_holds_its_levels(ntt, x):
    _, spans = recorded(lambda: ntt.compute_forward(x))
    (fwd,) = calls(spans, "sventt.forward")
    # the column leaf first, then the rows from the innermost level out
    assert direct(spans, fwd) == ["sventt.leaf", "sventt.row.L1", "sventt.row.L0"]
    assert not calls(spans, "sventt.inverse")


def test_an_inverse_holds_its_levels(ntt, x):
    _, spans = recorded(lambda: ntt.compute_inverse(x))
    (inv,) = calls(spans, "sventt.inverse")
    assert direct(spans, inv) == ["sventt.row.L0", "sventt.row.L1", "sventt.leaf"]


def test_a_product_holds_its_transforms_and_one_pointwise_step(ntt, x):
    y = residues(4)
    _, spans = recorded(lambda: [cyclic_convolve(ntt, x, y) for _ in range(2)])
    products = calls(spans, "sventt.convolve")
    assert len(products) == 2
    for p in products:
        assert direct(spans, p) == ["sventt.forward", "sventt.forward",
                                    "sventt.convolve.pointwise", "sventt.inverse"]
        assert [s[0] for s in inside(spans, p)].count("sventt.convolve.pointwise") == 1
        for call in calls(inside(spans, p), "sventt.forward"):
            assert direct(spans, call) == ["sventt.leaf", "sventt.row.L1", "sventt.row.L0"]


@pytest.mark.parametrize("engine, tables", [
    ("mxu", ["sventt.tables.twiddle", "sventt.tables.twiddle", "sventt.tables.mxu"]),
    ("pallas", ["sventt.tables.twiddle", "sventt.tables.lane", "sventt.tables.twiddle",
                "sventt.tables.pallas"]),
    ("jnp", ["sventt.tables.jnp"]),
])
def test_the_tables_spans(engine, tables):
    # jnp: 4096 is one leaf
    kw = {} if engine == "jnp" else {"max_fused": 16}
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, N, engine=engine, **kw)
    _, spans = recorded(lambda: NTT(cfg, device="cpu"))
    fwd, inv = calls(spans, "sventt.tables.forward"), calls(spans, "sventt.tables.inverse")
    assert len(fwd) == len(inv) == 1
    assert direct(spans, fwd[0]) == tables
    assert direct(spans, inv[0]) == tables
    assert not calls(spans, "sventt.forward")


def test_a_row_subtree_keeps_counting_depth(x):
    """The transpose fallback's recursion: a row that is itself a split
    names its levels one deeper than the level that holds it."""
    leaf = planner.Leaf(16, "pallas")
    plan = planner.Split(N, 16, 256, leaf, planner.Split(256, 16, 16, leaf, leaf))
    ref = NTT(config("pallas"), device="cpu")
    tables = planner.PlanTables(plan, ref.mod, ref.fc, inverse=False, device="cpu")
    out, spans = recorded(lambda: planner.run_forward(x, plan, tables))
    (root,) = calls(spans, "sventt.row.L0")
    assert direct(spans, root) == ["sventt.leaf", "sventt.row.L1"]
    assert torch.equal(out, ref.compute_forward(x))


class Counting:
    """A stand-in for ``record_function`` that counts its entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        Counting.entered += 1

    def __exit__(self, *exc):
        return False


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch, ntt, x):
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    Counting.entered = 0
    assert profiling.span("sventt.forward") is profiling._NULL
    assert profiling.span("sventt.row.L0") is profiling.span("sventt.leaf")
    NTT(config("mxu"), device="cpu")
    cyclic_convolve(ntt, x, x)
    ntt.compute_inverse(x)
    assert Counting.entered == 0
    # the same calls under a profiler do reach it
    with profile(activities=[ProfilerActivity.CPU]):
        ntt.compute_forward(x)
    assert Counting.entered > 0


def test_a_traced_call_gives_the_untraced_output_bit_for_bit(ntt, x):
    y = residues(5)

    def work():
        return ntt.compute_forward(x), ntt.compute_inverse(x), cyclic_convolve(ntt, x, y)

    off = work()
    on, spans = recorded(work)
    assert spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)
