"""The launch program of an eager butterfly or multi-modular call
(``planner.build_program``, ``ntt_pallas.LaunchProgram``) against the
planner's walk.

The tests need no card: they make one up. Every tensor reads as a
CUDA tensor, the kernel library is a recorder that keeps each C call's
name and arguments and computes nothing, and the card has 132 SMs and one
stream.  The walk (``forward_step`` / ``inverse_step``, the planner itself),
the call that builds a program and the calls that replay it must then
make the same C calls with the same arguments in the same order, the
data pointers compared by their role: the caller's input, or the output
of the k-th launch of the call.  No value is computed, so inputs and the
2^24 plan's root twiddles are left unwritten; the kernels' results are
checked on the card (``chip_smoke.py``).
"""

import types

import pytest
import torch

from sventt_tpu_torch import _build
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu_torch.ops import ntt_mxu, ntt_pallas
from sventt_tpu_torch.ops.twiddle import MontPair
from sventt_tpu_torch.plan import NTT, NttConfig, planner, wrapper

F, G = FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR
STREAM = 0x5EED


class Library:
    """The kernel library's stand-in: each C entry records (name, its
    arguments, the bytes ``watch``'s storage holds at the call) and
    returns 0, success."""

    def __init__(self):
        self.calls: list = []
        self.watch: torch.Tensor | None = None

    def __getattr__(self, name: str):
        if not name.startswith("sventt_"):
            raise AttributeError(name)

        def entry(*args):
            held = None if self.watch is None else self.watch.untyped_storage().nbytes()
            self.calls.append((name, args, held))
            return 0

        return entry

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


@pytest.fixture
def card(monkeypatch):
    """A made-up card (see the module docstring); "auto" resolves as on
    one.  Yields the library's stand-in."""
    lib = Library()
    rule = wrapper._resolve_engine
    monkeypatch.setattr(wrapper, "_resolve_engine", lambda config, device: rule(config, "cuda"))
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for module in (ntt_pallas, ntt_mxu):
        monkeypatch.setattr(module, "sm_count", lambda index: 132)
    monkeypatch.setattr(ntt_pallas, "current_stream", lambda device: STREAM)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=STREAM))
    ntt_pallas.reset_counts()
    yield lib
    ntt_pallas.reset_counts()


def roles(calls: list, x: int) -> list:
    """Each call's name and arguments, its input pointer named by its
    role ("x" for the pointer ``x``, or "out k": launch k's output), its
    output pointer "out i"; the stream must be the card's."""
    outs: dict = {}
    named = []
    for i, (name, args, _) in enumerate(calls):
        assert args[-1] == STREAM
        src = outs.get(args[0]) or ("x" if args[0] == x else args[0])
        outs[args[1]] = f"out {i}"
        named.append((name, src, f"out {i}", args[2:]))
    return named


def auto_2p24(inverse: bool) -> NTT:
    """The 2^24 auto plan's NTT, (256 x 256) x 256, with its tables made
    from parts: the leaf, lane and level-1 tables as built, the root's
    (65536, 256) twiddle pair allocated and left unwritten."""
    ntt = NTT(NttConfig(F, G, 1 << 24), enable_forward=False, enable_inverse=False,
              device="cpu")
    mod, fc = ntt.mod, ntt.fc
    leaf = {(256, "pallas"): ntt_pallas.make_leaf_tables(mod, 256, inverse=inverse,
                                                          modmul=fc.modmul, device="cpu")}
    lane = {256: ntt_pallas.make_lane_tables(mod, 256, inverse=inverse, modmul=fc.modmul,
                                             device="cpu")}
    root = MontPair(*(torch.empty((1 << 16, 256), dtype=torch.int64) for _ in range(2)))
    split_tw = {(256, 256): planner.row_twiddles(mod, 256, 256, inverse=inverse, device="cpu"),
                (1 << 16, 256): root}
    tables = planner.PlanTables.from_parts(ntt.plan, mod, fc, inverse, leaf=leaf,
                                           split_tw=split_tw, lane=lane)
    if inverse:
        ntt._inv_tables = tables
    else:
        ntt._fwd_tables = tables
    return ntt


#: (id, the NTT's config or None for the 2^24 auto plan, the input's shape)
CASES = [
    ("auto-2^17", NttConfig(F, G, 1 << 17), (1 << 17,)),
    ("auto-2^24", None, (1 << 24,)),
    ("auto-2^17-batched", NttConfig(F, G, 1 << 17), (1 << 17, 3)),
    ("pallas-spc-2^12", NttConfig(F, G, 1 << 12, engine="pallas", stages_per_call=4),
     (1 << 12,)),
    ("pallas-spc-2^12-batched", NttConfig(F, G, 1 << 12, engine="pallas", stages_per_call=4),
     (1 << 12, 2)),
    ("test-shoup-2^17", NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 17, modmul="shoup"),
     (1 << 17,)),
    ("solinas-2^17", NttConfig(F, G, 1 << 17, modmul="solinas"), (1 << 17,)),
    ("goldilocks-solinas-2^12", NttConfig(GOLDILOCKS_MODULUS, 7, 1 << 12, engine="pallas",
                                          modmul="solinas", max_fused=16), (1 << 12,)),
]


#: Two limbs of 63 and 62 bits.
RNS2 = NttConfig((TEST_MODULUS, 0x3FFF_C000_0000_0001), (TEST_GENERATOR, 11), 1 << 10)

#: (id, an RNS config, the input's shape): the "auto" cut (32 x 64) x 64
#: at 2^17 (lead, mid, lane), batched, lazy (the inverse's lane epilogue
#: unstaged), the matrix engine's own 256 x 512 and a one-leaf plan.
RNS_CASES = [
    ("rns-auto-2^17", NttConfig(RNS2.modulus, RNS2.generator, 1 << 17), (2, 1 << 17)),
    ("rns-auto-2^17-batched", NttConfig(RNS2.modulus, RNS2.generator, 1 << 17),
     (2, 1 << 17, 3)),
    ("rns-lazy-2^17", NttConfig(RNS2.modulus, RNS2.generator, 1 << 17, lazy=True),
     (2, 1 << 17)),
    ("rns-mxu-2^17", NttConfig(RNS2.modulus, RNS2.generator, 1 << 17, engine="mxu"),
     (2, 1 << 17)),
    ("rns-leaf-2^6", NttConfig(RNS2.modulus, RNS2.generator, 1 << 6), (2, 1 << 6)),
]


def make(cfg: NttConfig | None, inverse: bool) -> NTT:
    if cfg is None:
        return auto_2p24(inverse)
    return NTT(cfg, enable_forward=not inverse, enable_inverse=inverse, device="cpu")


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("cfg,shape", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_a_replay_makes_the_walks_launches(card, cfg, shape, inverse):
    """The walk, the call that builds the program and two replays make
    the same launches, arguments and counts, every launch counted under
    the configuration's stage multiply (``MODMUL``) and once by its
    inter-step twiddle's form (``TWIDDLE``); a replay's result is its last
    launch's output in the walk's shape."""
    ntt = make(cfg, inverse)
    step, tables = ntt.inverse_step() if inverse else ntt.forward_step()
    call = ntt.compute_inverse if inverse else ntt.compute_forward
    x = torch.empty(shape, dtype=torch.int64)
    want_out = step(x, *tables)
    want = roles(card.take(), x.data_ptr())
    walk_counts = (dict(ntt_pallas.LAUNCHES), dict(ntt_pallas.KERNEL_LAUNCHES),
                   dict(ntt_pallas.MODMUL), dict(ntt_pallas.TWIDDLE))
    assert want and {name for name, *_ in want} == {"sventt_radix2_ntt"}
    assert sum(walk_counts[0].values()) == walk_counts[1]["radix2_registers"] == len(want)
    assert walk_counts[2] == {k: len(want) * (k == ntt.fc.modmul) for k in ntt_pallas.MODMUL}
    assert sum(walk_counts[3].values()) == len(want)
    assert ntt_pallas.PROGRAMS == {"built": 0, "replayed": 0}
    for i in range(3):
        ntt_pallas.reset_counts()
        y = torch.empty(shape, dtype=torch.int64)
        out = call(y)
        calls = card.take()
        assert roles(calls, y.data_ptr()) == want, i
        assert (dict(ntt_pallas.LAUNCHES), dict(ntt_pallas.KERNEL_LAUNCHES),
                dict(ntt_pallas.MODMUL), dict(ntt_pallas.TWIDDLE)) == walk_counts
        assert ntt_pallas.PROGRAMS == {"built": int(i == 0), "replayed": int(i > 0)}
        assert out.shape == want_out.shape and out.is_contiguous()
        assert out.data_ptr() == calls[-1][1][1]
    program = ntt._programs[(inverse, tuple(shape), y.stride())]
    assert {launch.modmul for launch in program.launches} == {ntt.fc.modmul}


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("cfg,shape", [c[1:] for c in RNS_CASES], ids=[c[0] for c in RNS_CASES])
def test_an_rns_replay_makes_the_walks_launches(card, cfg, shape, inverse):
    """A multi-modular call: the walk, the call that builds the program
    and two replays make the same tensor-core limb launches, arguments
    and counts (one launch a level, every limb in each); a replay's result
    is its last launch's output in the walk's shape."""
    ntt = make(cfg, inverse)
    ntt_mxu.reset_counts()
    step, tables = ntt.inverse_step() if inverse else ntt.forward_step()
    call = ntt.compute_inverse if inverse else ntt.compute_forward
    x = torch.empty(shape, dtype=torch.int64)
    want_out = step(x, *tables)
    want = roles(card.take(), x.data_ptr())
    walk_counts = (dict(ntt_mxu.LAUNCHES), dict(ntt_mxu.KERNEL_LAUNCHES), dict(ntt_mxu.LIMBS))
    levels = str(ntt.plan).count("Leaf(")
    assert [name for name, *_ in want] == ["sventt_mxu_ntt_tc_limbs"] * levels
    assert walk_counts[1] == {"tensor_core": levels}
    assert walk_counts[2] == {"tensor_core": 2 * levels}
    for i in range(3):
        ntt_mxu.reset_counts()
        ntt_pallas.reset_counts()
        y = torch.empty(shape, dtype=torch.int64)
        out = call(y)
        calls = card.take()
        assert roles(calls, y.data_ptr()) == want, i
        assert (dict(ntt_mxu.LAUNCHES), dict(ntt_mxu.KERNEL_LAUNCHES),
                dict(ntt_mxu.LIMBS)) == walk_counts
        assert ntt_pallas.PROGRAMS == {"built": int(i == 0), "replayed": int(i > 0)}
        assert out.shape == want_out.shape and out.is_contiguous()
        assert out.data_ptr() == calls[-1][1][1]
    ntt_mxu.reset_counts()


def test_one_program_a_direction_shape_and_strides(card):
    """A program is built on the first call of each (direction, shape,
    strides) and replayed by every later one, whatever tensor it gets."""
    ntt = NTT(NttConfig(F, G, 1 << 10), device="cpu")
    n = 1 << 10
    calls = [
        (ntt.compute_forward, (n,)), (ntt.compute_forward, (n,)), (ntt.compute_forward, (n,)),
        (ntt.compute_forward, (n, 2)), (ntt.compute_inverse, (n,)),
        (ntt.compute_forward, (n, 2)), (ntt.compute_inverse, (n,)),
    ]
    built = [1, 1, 1, 2, 3, 3, 3]
    for (fn, shape), b in zip(calls, built):
        fn(torch.empty(shape, dtype=torch.int64))
        assert ntt_pallas.PROGRAMS["built"] == b
    assert ntt_pallas.PROGRAMS["replayed"] == len(calls) - 3
    # contiguous (n, 1) tensors whose unit axis has another stride: keys of their own
    for stride, b in (((1, 1), 4), ((1, 7), 5), ((1, 1), 5), ((1, 7), 5)):
        ntt.compute_forward(torch.empty((n, 1), dtype=torch.int64).as_strided((n, 1), stride))
        assert ntt_pallas.PROGRAMS["built"] == b
    assert ntt_pallas.PROGRAMS["replayed"] == len(calls) - 3 + 2


@pytest.mark.parametrize("case", ["non-contiguous", "grouped", "mxu", "jnp", "rns", "row-subtree",
                                  "rns-misaligned"])
def test_other_calls_build_no_program(card, case):
    """Calls that are not a chain of radix-2 register or tensor-core limb
    launches on contiguous, 16-byte aligned data walk the plan every time:
    a non-contiguous input (of one modulus, and of an RNS configuration),
    the grouped, matrix and jnp engines of one modulus, a row subtree (the
    transpose fallback), an RNS input at an 8-byte offset."""
    n = 1 << 10
    cfg = {
        "non-contiguous": NttConfig(F, G, n),
        "grouped": NttConfig(F, G, n, engine="pallas", max_r=2),
        "mxu": NttConfig(F, G, n, engine="mxu"),
        "jnp": NttConfig(F, G, 1 << 14, engine="jnp"),
        "rns": RNS2,
        "row-subtree": NttConfig(F, G, 1 << 12, engine="pallas", strategy="six_step",
                                 n0=16, n1=256, max_fused=16),
        "rns-misaligned": RNS2,
    }[case]
    ntt = NTT(cfg, device="cpu")
    if case == "row-subtree":
        assert isinstance(ntt.plan.row, planner.Split)
    shape = (2, cfg.n) if cfg.rns else (cfg.n,)
    for _ in range(3):
        for call in (ntt.compute_forward, ntt.compute_inverse):
            if case == "rns-misaligned":
                x = torch.empty(2 * cfg.n + 1, dtype=torch.int64)[1:].view(shape)
                assert x.is_contiguous() and x.data_ptr() % 16 == 8
            else:
                x = torch.empty(shape + (2,), dtype=torch.int64)
                x = x[..., 0] if case in ("non-contiguous", "rns") else x[..., 0].contiguous()
            call(x)
            assert card.take()
    assert ntt_pallas.PROGRAMS == {"built": 0, "replayed": 0}
    for tables in (ntt._fwd_tables, ntt._inv_tables):
        assert planner.replayable(ntt.plan, tables, False) == (
            case in ("non-contiguous", "rns", "rns-misaligned"))


def test_a_cpu_call_builds_no_program():
    """Off the card the plain versions run, and no program is built."""
    ntt_pallas.reset_counts()
    ntt = NTT(NttConfig(F, G, 1 << 10, engine="pallas"), device="cpu")
    x = torch.zeros(1 << 10, dtype=torch.int64)
    for _ in range(2):
        assert torch.equal(ntt.compute_inverse(ntt.compute_forward(x)), x)
    assert ntt_pallas.PROGRAMS == {"built": 0, "replayed": 0}
    assert ntt_pallas.PLAIN_CALLS["leaf"] > 0


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_a_donated_input_is_released_after_its_first_launch(card, inverse):
    """With ``donate_input`` the caller's storage is whole at the first
    launch and released at the second, on the building call and on
    replays; the launches are the walk's on a kept input."""
    n = 1 << 17
    ntt = NTT(NttConfig(F, G, n), donate_input=True, device="cpu")
    step, tables = ntt.inverse_step() if inverse else ntt.forward_step()
    call = ntt.compute_inverse if inverse else ntt.compute_forward
    y = torch.empty(n, dtype=torch.int64)
    step(y, *tables)
    want = roles(card.take(), y.data_ptr())
    for i in range(3):
        x = torch.empty(n, dtype=torch.int64)
        card.watch, ptr = x, x.data_ptr()
        call(x)
        calls = card.take()
        assert [held for *_, held in calls] == [8 * n, 0], i
        assert roles(calls, ptr) == want, i
        assert x.untyped_storage().nbytes() == 0
    assert ntt_pallas.PROGRAMS == {"built": 1, "replayed": 2}
