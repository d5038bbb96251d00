"""PyTorch port, the portable engine: ``ops/ntt_jnp.py``, the planner's jnp
paths, the wrappers' step helpers and the distributed jnp row leaf, against
sventt_tpu's jnp engine on the CPU.

Inputs are made with numpy from a seed; outputs are compared bit for bit as
uint64 words (tolerance zero: the arithmetic is exact, and the port runs the
JAX engine's schedule and multiplies, lazy representatives included), and
every roundtrip must return its input exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from sventt_tpu.field.limb import FieldConsts as JFieldConsts
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.ops import ntt_jnp as jntt_jnp
from sventt_tpu.ops import twiddle as jtwiddle
from sventt_tpu.parallel import DistributedNTT as JDistributedNTT
from sventt_tpu.parallel import make_ntt_mesh as jmake_ntt_mesh
from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu_torch import FieldConsts, GoldenNTT
from sventt_tpu_torch.field.limb import from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import inter_step, ntt_jnp, ntt_mxu, ntt_pallas, twiddle
from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu_torch.plan import NTT, NttConfig, planner

MODS = {
    "test62": (TEST_MODULUS, TEST_GENERATOR),
    "flagship": (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR),
    "goldilocks": (GOLDILOCKS_MODULUS, 7),
}
#: (modulus, modmul) cases of the engine functions: every engine of each
#: modulus (Shoup needs a lazy modulus, Solinas a sparse-high 64-bit one)
ENGINE_CASES = [
    ("test62", "montgomery"), ("test62", "shoup"),
    ("flagship", "montgomery"), ("flagship", "solinas"),
    ("goldilocks", "montgomery"), ("goldilocks", "solinas"),
]


def _both(key: str, modmul: str):
    N, g = MODS[key]
    from sventt_tpu.field.modulus import Modulus as JModulus

    jmod, mod = JModulus(N, g), Modulus(N, g)
    return jmod, JFieldConsts.from_modulus(jmod, modmul=modmul), mod, FieldConsts.from_modulus(
        mod, modmul=modmul
    )


@pytest.mark.parametrize("log2m", range(1, 7))
@pytest.mark.parametrize("key,modmul", ENGINE_CASES, ids=lambda v: str(v))
def test_engine_functions_match_jax(rng, key, modmul, log2m):
    """ntt_forward / ntt_inverse (leading axis, batched) and the _mid
    variants (axis 1 of (A, m, B)) equal the JAX engine's at m = 2 .. 64,
    and each roundtrip is exact after normalize."""
    m = 1 << log2m
    jmod, jfc, mod, fc = _both(key, modmul)
    N = mod.modulus
    jft, jit = jtwiddle.forward_tables(jmod, m, modmul), jtwiddle.inverse_tables(jmod, m, 1, modmul)
    ft = twiddle.forward_tables(mod, m, modmul, device="cpu")
    it = twiddle.inverse_tables(mod, m, modmul=modmul, device="cpu")
    for axis, shape in ((0, (m, 3)), (1, (2, m, 3))):
        x = rng.integers(0, N, shape, dtype=np.uint64)
        jf, ji = (jntt_jnp.ntt_forward, jntt_jnp.ntt_inverse) if axis == 0 else (
            jntt_jnp.ntt_forward_mid, jntt_jnp.ntt_inverse_mid)
        f, i = (ntt_jnp.ntt_forward, ntt_jnp.ntt_inverse) if axis == 0 else (
            ntt_jnp.ntt_forward_mid, ntt_jnp.ntt_inverse_mid)
        got_f = f(from_numpy(x), ft, fc)
        np.testing.assert_array_equal(to_numpy(got_f), u64_to_numpy(jf(u64_from_numpy(x), jft, jfc)))
        np.testing.assert_array_equal(
            to_numpy(i(from_numpy(x), it, fc)), u64_to_numpy(ji(u64_from_numpy(x), jit, jfc))
        )
        back = to_numpy(fc.normalize(i(fc.normalize(got_f), it, fc)))
        np.testing.assert_array_equal(back, x)


def test_engine_against_golden_and_checks(rng):
    """The forward of one column equals GoldenNTT; a wrong axis length
    raises as in JAX; the pointwise helpers equal JAX's."""
    jmod, jfc, mod, fc = _both("flagship", "montgomery")
    m = 32
    x = rng.integers(0, mod.modulus, m, dtype=np.uint64)
    ft = twiddle.forward_tables(mod, m, device="cpu")
    got = to_numpy(fc.normalize(ntt_jnp.ntt_forward(from_numpy(x), ft, fc)))
    assert [int(v) for v in got] == GoldenNTT(m, mod).forward([int(v) for v in x])
    with pytest.raises(ValueError, match="leading axis"):
        ntt_jnp.ntt_forward(from_numpy(x[:16]), ft, fc)
    with pytest.raises(ValueError, match="axis-1"):
        ntt_jnp.ntt_forward_mid(from_numpy(x[:16].reshape(1, 16)), ft, fc)
    a, b = (rng.integers(0, mod.modulus, (8, 4), dtype=np.uint64) for _ in range(2))
    np.testing.assert_array_equal(
        to_numpy(ntt_jnp.pointwise_mont_mul(from_numpy(a), from_numpy(b), fc)),
        u64_to_numpy(jntt_jnp.pointwise_mont_mul(u64_from_numpy(a), u64_from_numpy(b), jfc)),
    )
    tw = twiddle.sixstep_row_twiddles(mod, 8, 4, device="cpu")
    jtw = jtwiddle.sixstep_row_twiddles(jmod, 8, 4)
    np.testing.assert_array_equal(
        to_numpy(ntt_jnp.twiddle_rows(from_numpy(a), tw, fc)),
        u64_to_numpy(jntt_jnp.twiddle_rows(u64_from_numpy(a), jtw, jfc)),
    )


@pytest.mark.parametrize(
    "key,n,kw",
    [
        ("flagship", 1 << 10, {}),
        ("test62", 1 << 10, {}),
        ("flagship", 1 << 12, dict(strategy="six_step", n0=64, n1=64)),
        ("test62", 1 << 12, dict(max_fused=16)),
        ("flagship", 1 << 12, dict(max_fused=16, modmul="solinas")),
        ("test62", 1 << 12, dict(modmul="shoup", chunk_elems=512)),
    ],
    ids=["flagship-2^10", "test62-2^10", "flagship-2^12-split", "test62-2^12-3level",
         "flagship-2^12-solinas", "test62-2^12-shoup-chunked"],
)
def test_jnp_ntt_matches_jax(rng, key, n, kw):
    """NTT(engine="jnp"): the same plan as JAX, forward and inverse equal
    bitwise, an exact roundtrip, and no kernel wrapper called."""
    N, g = MODS[key]
    ntt = NTT(NttConfig(N, g, n, engine="jnp", **kw), device="cpu")
    ref = JNTT(JNttConfig(N, g, n, engine="jnp", **kw))
    assert ntt.engine == "jnp" and repr(ntt.plan) == repr(ref.plan)
    x = rng.integers(0, N, n, dtype=np.uint64)
    ntt_mxu.reset_counts()
    ntt_pallas.reset_counts()
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(x), ref.inverse_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)
    assert not any(ntt_mxu.PLAIN_CALLS.values()) and not any(ntt_pallas.PLAIN_CALLS.values())


def test_chunked_matches_unchunked(rng):
    """The chunk loops (leaf columns, row chunks with their twiddles) give
    the unchunked bits at every chunk size, and JAX's with the same knob."""
    N, g = MODS["flagship"]
    n = 1 << 12
    x = from_numpy(rng.integers(0, N, (n, 2), dtype=np.uint64))
    outs = {}
    for chunk in (None, 1 << 6, 1 << 8, 1 << 10, 1 << 20):
        ntt = NTT(NttConfig(N, g, n, engine="jnp", max_fused=64, chunk_elems=chunk), device="cpu")
        outs[chunk] = (to_numpy(ntt.compute_forward(x)), to_numpy(ntt.compute_inverse(x)))
    for chunk, (f, i) in outs.items():
        np.testing.assert_array_equal(f, outs[None][0], err_msg=str(chunk))
        np.testing.assert_array_equal(i, outs[None][1], err_msg=str(chunk))
    ref = JNTT(JNttConfig(N, g, n, engine="jnp", max_fused=64, chunk_elems=1 << 8))
    np.testing.assert_array_equal(
        outs[1 << 8][0], u64_to_numpy(ref.compute_forward(u64_from_numpy(to_numpy(x))))
    )


def test_chunk_helpers_split_as_asked(rng, monkeypatch):
    """_jnp_chunked / _jnp_mid_chunked call the engine once per chunk of
    at most chunk_elems elements, and once where the chunk does not divide."""
    mod = Modulus(*MODS["test62"])
    fc = FieldConsts.from_modulus(mod)
    ft = twiddle.forward_tables(mod, 16, device="cpu")
    x = from_numpy(rng.integers(0, mod.modulus, (16, 8, 4), dtype=np.uint64))
    calls = []

    def spy(fn):
        def wrapped(v, t, fc):
            calls.append(tuple(v.shape))
            return fn(v, t, fc)
        return wrapped

    whole = ntt_jnp.ntt_forward(x, ft, fc)
    got = planner._jnp_chunked(x, ft, fc, spy(ntt_jnp.ntt_forward), chunk_elems=128)
    assert calls == [(16, 8)] * 4 and torch.equal(got, whole)
    calls.clear()
    planner._jnp_chunked(x, ft, fc, spy(ntt_jnp.ntt_forward), chunk_elems=16 * 3)
    assert calls == [(16, 8, 4)]  # 3 columns do not divide 32: one call
    monkeypatch.setattr(planner, "ntt_forward_mid", spy(ntt_jnp.ntt_forward_mid))
    calls.clear()
    y = x.reshape(8, 16, 4)
    tw = twiddle.sixstep_row_twiddles(mod, 8, 16, device="cpu")
    got = planner._jnp_mid_chunked(y, ft, fc, tw, False, chunk_elems=2 * 16 * 4)
    assert calls == [(2, 16, 4)] * 4
    want = ntt_jnp.ntt_forward_mid(inter_step.mont_mul_bcast(fc, y, tw), ft, fc)
    assert torch.equal(got, want)


PLAN_SPECS = [
    ("jnp:64,jnp", 1 << 12),
    ("jnp:16,mxu:16,jnp", 1 << 12),
    ("mxu:64,jnp", 1 << 12),
    ("jnp:32,pallas:8,mxu", 1 << 10),
    ("pallas:16,jnp:16,pallas", 1 << 10),
    ("jnp:32,jnp:32,mxu", 1 << 14),
]


@pytest.mark.parametrize("spec,n", PLAN_SPECS, ids=[s for s, _ in PLAN_SPECS])
def test_mixed_plan_spec_matches_jax(rng, spec, n):
    """Mixed trees with jnp leaves and rows: bitwise JAX's, exact roundtrip."""
    N, g = MODS["flagship"]
    ntt = NTT(NttConfig(N, g, n, plan_spec=spec), device="cpu")
    ref = JNTT(JNttConfig(N, g, n, plan_spec=spec))
    x = rng.integers(0, N, n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(x), ref.inverse_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("spec", [None, "jnp:64,pallas:8,jnp", "pallas:16,jnp:16,pallas"])
def test_describe_jnp_against_jax(spec, batched):
    """describe() of jnp plans is the JAX text line for line."""
    cfg = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12)
    kw = dict(engine="jnp", max_fused=16) if spec is None else dict(plan_spec=spec)
    port = NTT(NttConfig(*cfg, **kw), enable_inverse=False, device="cpu").describe(batched)
    ref = JNTT(JNttConfig(*cfg, **kw), enable_inverse=False).describe(batched)
    assert port == ref
    assert "mid-axis jnp m1=" in port


def test_step_helpers_match_compute(rng):
    """forward_step / inverse_step run the same planner program as
    compute_forward / compute_inverse (mxu and jnp plans), and refuse a
    direction that was not enabled, as in JAX."""
    N, g = MODS["test62"]
    for kw in ({}, dict(engine="jnp")):
        ntt = NTT(NttConfig(N, g, 1 << 11, **kw), device="cpu")
        x = from_numpy(rng.integers(0, N, 1 << 11, dtype=np.uint64))
        step_f, tabs_f = ntt.forward_step()
        fwd = ntt.compute_forward(x)
        assert torch.equal(ntt.normalize(step_f(x, *tabs_f)), ntt.normalize(fwd))
        step_i, tabs_i = ntt.inverse_step()
        assert torch.equal(
            ntt.normalize(step_i(fwd, *tabs_i)), ntt.normalize(ntt.compute_inverse(fwd))
        )
    only_fwd = NTT(NttConfig(N, g, 1 << 8), enable_inverse=False, device="cpu")
    with pytest.raises(RuntimeError):
        only_fwd.inverse_step()
    with pytest.raises(RuntimeError):
        NTT(NttConfig(N, g, 1 << 8), enable_forward=False, device="cpu").forward_step()


@functools.lru_cache(maxsize=None)
def _jax_distributed(n: int):
    """x, forward(x), inverse(x) of the JAX DistributedNTT (its jnp engine
    off the TPU) over 4 CPU devices, normalized."""
    cfg = JNttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step")
    dntt = JDistributedNTT(cfg, jmake_ntt_mesh(4))
    x = np.random.default_rng(n).integers(0, TEST_MODULUS, n, dtype=np.uint64)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd = u64_to_numpy(dntt.fc.normalize(dntt.compute_forward(xd)))
    inv = u64_to_numpy(dntt.fc.normalize(dntt.compute_inverse(xd)))
    return x, fwd, inv


@pytest.mark.parametrize("comm", ["xla", "ring", "overlap"])
def test_distributed_jnp_row_leaf(comm, monkeypatch):
    """DistributedNTT(engine="jnp") at D = 4 CPU shards: the row leaf runs
    along axis 1 with no local transpose, and forward, inverse and the
    roundtrip equal the JAX DistributedNTT's; the step helpers equal the
    compute calls."""
    n = 1 << 12
    x, fwd, inv = _jax_distributed(n)
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, n, strategy="six_step", engine="jnp")
    dntt = DistributedNTT(cfg, make_ntt_mesh(devices=["cpu"] * 4), comm=comm)
    assert dntt._row_plan == planner.Leaf(64, "jnp")
    from sventt_tpu_torch.parallel import sixstep

    transposes = []

    def counted(*args):
        transposes.append(args[0].shape)
        return sixstep.transpose01_u64.__wrapped__(*args)

    counted.__wrapped__ = sixstep.transpose01_u64
    monkeypatch.setattr(sixstep, "transpose01_u64", counted)
    shards = dntt.shard(x)
    out = dntt.compute_forward(shards)
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(out))), fwd)
    got = dntt.compute_inverse(shards)
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(got))), inv)
    back = dntt.compute_inverse(out)
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(back))), x)
    assert transposes == []
    step, tabs = dntt.forward_step()
    assert all(torch.equal(a, b) for a, b in zip(step(shards, *tabs), out))
    step, tabs = dntt.inverse_step()
    assert all(torch.equal(a, b) for a, b in zip(step(out, *tabs), back))


def test_distributed_step_helpers_refuse_disabled():
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 8, strategy="six_step", engine="jnp")
    mesh = make_ntt_mesh(devices=["cpu"] * 4)
    with pytest.raises(RuntimeError):
        DistributedNTT(cfg, mesh, enable_forward=False).forward_step()
    with pytest.raises(RuntimeError):
        DistributedNTT(cfg, mesh, enable_inverse=False).inverse_step()


def test_engine_auto_stays_mxu():
    """engine="auto" resolves to the matrix engine on every device; "jnp"
    is asked for by name."""
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10)
    assert NTT(cfg, device="cpu").engine == "mxu"
    assert NTT(cfg.with_(engine="jnp"), device="cpu").plan == planner.Leaf(1 << 10, "jnp")
