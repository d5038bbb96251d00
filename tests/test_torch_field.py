"""PyTorch port, field layer: bitwise against sventt_tpu.field.

Inputs are made with numpy from a seed and go through the JAX function
(u32 limb pairs) and the port (int64 bit patterns).  The tolerance is zero:
the arithmetic is exact, so every output word must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from sventt_tpu.field import golden as jgolden
from sventt_tpu.field import limb as jlimb
from sventt_tpu.field import modulus as jmodulus
from sventt_tpu_torch.field import golden, limb, modulus

N_FLAG = modulus.FLAGSHIP_MODULUS
N_TEST = modulus.TEST_MODULUS
N_GOLD = modulus.GOLDILOCKS_MODULUS
N_F4 = 65537

# (modulus, generator, lazy): 64-bit moduli run canonical only; the 62-bit
# test modulus and F4 run both lazy and canonical
FIELD_CASES = [
    pytest.param(N_FLAG, 3, False, id="flagship"),
    pytest.param(N_GOLD, 7, False, id="goldilocks"),
    pytest.param(N_TEST, 3, True, id="test-lazy"),
    pytest.param(N_TEST, 3, False, id="test-canonical"),
    pytest.param(N_F4, 3, True, id="f4-lazy"),
    pytest.param(N_F4, 3, False, id="f4-canonical"),
]


def _values(rng, N: int, count: int = 509, below: int | None = None) -> np.ndarray:
    """Random values plus the edge cases 0, 1, N-1, N, 2^63 and 2^64-1."""
    hi = (1 << 64) if below is None else below
    v = rng.integers(0, hi, count, dtype=np.uint64)
    edges = [0, 1, N - 1, N, 1 << 63, (1 << 64) - 1]
    edges = [e for e in edges if e < hi]
    return np.concatenate([v, np.array(edges, dtype=np.uint64)])


def _jax(fn, *arrays):
    out = fn(*[jlimb.u64_from_numpy(a) for a in arrays])
    return jlimb.u64_to_numpy(out)


def _port(fn, *arrays):
    return limb.to_numpy(fn(*[limb.from_numpy(a) for a in arrays]))


def _pair(N: int, w: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return w * np.uint64(pow(N, -1, 1 << 64))


@pytest.mark.parametrize("N,g,lazy", FIELD_CASES)
def test_mont_mul(rng, N, g, lazy):
    mod_j, mod_p = jmodulus.Modulus(N, g), modulus.Modulus(N, g)
    fj = jlimb.FieldConsts.from_modulus(mod_j, lazy=lazy)
    fp = limb.FieldConsts.from_modulus(mod_p, lazy=lazy)
    a = _values(rng, N)
    w = _values(rng, N, below=N)[: a.size]
    w = np.resize(w, a.size)
    wp = _pair(N, w)
    np.testing.assert_array_equal(_port(fp.mont_mul, a, w, wp), _jax(fj.mont_mul, a, w, wp))


@pytest.mark.parametrize("N,g,lazy", FIELD_CASES)
def test_mont_mul_full(rng, N, g, lazy):
    fj = jlimb.FieldConsts.from_modulus(jmodulus.Modulus(N, g), lazy=lazy)
    fp = limb.FieldConsts.from_modulus(modulus.Modulus(N, g), lazy=lazy)
    a = _values(rng, N)
    b = np.resize(_values(rng, N, below=N), a.size)
    np.testing.assert_array_equal(_port(fp.mont_mul_full, a, b), _jax(fj.mont_mul_full, a, b))


@pytest.mark.parametrize("N,g,lazy", FIELD_CASES)
def test_normalize(rng, N, g, lazy):
    fj = jlimb.FieldConsts.from_modulus(jmodulus.Modulus(N, g), lazy=lazy)
    fp = limb.FieldConsts.from_modulus(modulus.Modulus(N, g), lazy=lazy)
    # the lazy contract: representatives in [0, 2N)
    a = _values(rng, N, below=2 * N if 2 * N < (1 << 64) else None)
    np.testing.assert_array_equal(_port(fp.normalize, a), _jax(fj.normalize, a))


@pytest.mark.parametrize("N,g,lazy", FIELD_CASES)
def test_field_consts_fields(N, g, lazy):
    fj = jlimb.FieldConsts.from_modulus(jmodulus.Modulus(N, g), lazy=lazy)
    fp = limb.FieldConsts.from_modulus(modulus.Modulus(N, g), lazy=lazy)
    assert (fp.modulus, fp.montgomery_inverse, fp.lazy, fp.modmul) == (
        fj.modulus, fj.montgomery_inverse, fj.lazy, fj.modmul
    )
    assert (fp.n_form, fp.n_c, fp.n_s) == (fj.n_form, fj.n_c, fj.n_s)


@pytest.mark.parametrize(
    "name", ["u64_mulhi", "u64_mullo", "u64_add", "u64_sub", "u64_lt", "u64_add_carry"]
)
def test_u64_primitives(rng, name):
    a = _values(rng, N_FLAG)
    b = np.resize(_values(rng, N_FLAG)[::-1], a.size)
    jfn, pfn = getattr(jlimb, name), getattr(limb, name)
    if name == "u64_lt":
        want = np.asarray(jfn(jlimb.u64_from_numpy(a), jlimb.u64_from_numpy(b)))
        got = pfn(limb.from_numpy(a), limb.from_numpy(b)).numpy()
    elif name == "u64_add_carry":
        s, c = jfn(jlimb.u64_from_numpy(a), jlimb.u64_from_numpy(b))
        ps, pc = pfn(limb.from_numpy(a), limb.from_numpy(b))
        np.testing.assert_array_equal(limb.to_numpy(ps), jlimb.u64_to_numpy(s))
        want, got = np.asarray(c), pc.numpy()
    else:
        want = _jax(jfn, a, b)
        got = _port(pfn, a, b)
    np.testing.assert_array_equal(got.astype(np.uint64), want.astype(np.uint64))


def test_u64_select(rng):
    a, b = _values(rng, N_FLAG), _values(rng, N_FLAG)
    pred = rng.integers(0, 2, a.size).astype(bool)
    want = jlimb.u64_to_numpy(
        jlimb.u64_select(pred, jlimb.u64_from_numpy(a), jlimb.u64_from_numpy(b))
    )
    got = limb.u64_select(torch.from_numpy(pred), limb.from_numpy(a), limb.from_numpy(b))
    np.testing.assert_array_equal(limb.to_numpy(got), want)


@pytest.mark.parametrize("N", [N_FLAG, N_TEST, N_GOLD, N_F4, (1 << 61) - 1])
def test_detect_sparse_modulus(N):
    assert limb.detect_sparse_modulus(N) == jlimb.detect_sparse_modulus(N)


def test_limb_conversions_roundtrip(rng):
    a = _values(rng, N_FLAG)
    hi, lo = limb.to_limbs(limb.from_numpy(a))
    j = jlimb.u64_from_numpy(a)
    np.testing.assert_array_equal(hi, np.asarray(j.hi))
    np.testing.assert_array_equal(lo, np.asarray(j.lo))
    np.testing.assert_array_equal(limb.to_numpy(limb.from_limbs(hi, lo)), a)
    assert limb.u64(limb.s64((1 << 64) - 1)) == (1 << 64) - 1


def test_modulus_matches_jax():
    for N, g in [(N_FLAG, 3), (N_TEST, 3), (N_GOLD, 7), (N_F4, 3)]:
        p, j = modulus.Modulus(N, g), jmodulus.Modulus(N, g)
        for attr in ("montgomery_inverse", "montgomery_r", "montgomery_r2",
                     "shoup_inverse", "bit_width", "two_adicity"):
            assert getattr(p, attr) == getattr(j, attr), (N, attr)
        for order in (2, 256, 1 << 16):
            assert p.get_root_forward(order) == j.get_root_forward(order)
    assert modulus.find_ntt_prime(40, 20) == jmodulus.find_ntt_prime(40, 20)


@pytest.mark.parametrize("N,g", [(N_FLAG, 3), (N_TEST, 3)])
def test_golden_matches_jax(rng, N, g):
    m = 64
    x = [int(v) for v in rng.integers(0, N, m, dtype=np.uint64)]
    p = golden.GoldenNTT(m, modulus.Modulus(N, g))
    j = jgolden.GoldenNTT(m, jmodulus.Modulus(N, g))
    assert p.forward(x) == j.forward(x)
    assert p.inverse(x) == j.inverse(x)
    assert golden.bitreverse_permutation(m) == jgolden.bitreverse_permutation(m)


# -- lazy/canonical add and sub, Shoup, the butterflies -----------------------

# (modulus, generator, lazy, stage-multiply engine): Shoup needs lazy mode
ENGINE_CASES = [
    pytest.param(*p.values, "montgomery", id=f"{p.id}-mont") for p in FIELD_CASES
] + [
    pytest.param(N_TEST, 3, True, "shoup", id="test-lazy-shoup"),
    pytest.param(N_F4, 3, True, "shoup", id="f4-lazy-shoup"),
]


def _consts(N, g, lazy, modmul="montgomery"):
    return (
        jlimb.FieldConsts.from_modulus(jmodulus.Modulus(N, g), lazy=lazy, modmul=modmul),
        limb.FieldConsts.from_modulus(modulus.Modulus(N, g), lazy=lazy, modmul=modmul),
    )


def _in_contract(rng, N: int, lazy: bool, count: int = 509) -> np.ndarray:
    """Values in [0, 2N) (lazy) or [0, N), with both ends of the range."""
    top = 2 * N if lazy else N
    v = rng.integers(0, top, count, dtype=np.uint64)
    return np.concatenate([v, np.array([0, 1, N - 1, top - 1], dtype=np.uint64)])


def _engine_pair(N: int, g: int, modmul: str, w: np.ndarray) -> np.ndarray:
    """The companion of plain-domain twiddles ``w`` for ``modmul``."""
    if modmul == "shoup":
        mod = modulus.Modulus(N, g)
        return np.array([mod.shoup_precompute(int(v)) for v in w], dtype=np.uint64)
    return _pair(N, w)


@pytest.mark.parametrize("N,g,lazy", FIELD_CASES)
def test_add_sub(rng, N, g, lazy):
    fj, fp = _consts(N, g, lazy)
    a = _in_contract(rng, N, lazy)
    b = np.resize(_in_contract(rng, N, lazy)[::-1], a.size)
    for name in ("add", "sub"):
        got = _port(getattr(fp, name), a, b)
        np.testing.assert_array_equal(got, _jax(getattr(fj, name), a, b), err_msg=name)


def test_u64_min(rng):
    a = _values(rng, N_FLAG)
    b = np.resize(_values(rng, N_FLAG)[::-1], a.size)
    np.testing.assert_array_equal(_port(limb.u64_min, a, b), _jax(jlimb.u64_min, a, b))


@pytest.mark.parametrize("N,g,lazy,modmul", ENGINE_CASES)
def test_twiddle_mul(rng, N, g, lazy, modmul):
    """Montgomery or Shoup stage multiply on full-range a (incl. 2^64-1)."""
    fj, fp = _consts(N, g, lazy, modmul)
    assert fp.modmul == fj.modmul == modmul
    a = _values(rng, N)
    w = np.resize(_values(rng, N, below=N), a.size)
    wp = _engine_pair(N, g, modmul, w)
    np.testing.assert_array_equal(
        _port(fp.twiddle_mul, a, w, wp), _jax(fj.twiddle_mul, a, w, wp)
    )
    if modmul == "shoup":
        np.testing.assert_array_equal(
            _port(fp.shoup_mul, a, w, wp), _jax(fj.shoup_mul, a, w, wp)
        )


@pytest.mark.parametrize("N,g,lazy,modmul", ENGINE_CASES)
def test_butterflies(rng, N, g, lazy, modmul):
    """DIF, DIT and the scaled last DIT butterfly, bit for bit before any
    normalize (lazy representatives included)."""
    fj, fp = _consts(N, g, lazy, modmul)
    x0 = _in_contract(rng, N, lazy)
    x1 = np.resize(_in_contract(rng, N, lazy)[::-1], x0.size)
    w = np.resize(_values(rng, N, below=N), x0.size)
    s = np.full(x0.size, rng.integers(1, N, dtype=np.uint64), dtype=np.uint64)
    wp, sp = _engine_pair(N, g, modmul, w), _engine_pair(N, g, modmul, s)
    cases = [
        ("butterfly_forward", (x0, x1, w, wp)),
        ("butterfly_inverse", (x0, x1, w, wp)),
        ("butterfly_inverse_scaled", (x0, x1, s, sp, w, wp)),
    ]
    for name, args in cases:
        got = getattr(fp, name)(*[limb.from_numpy(v) for v in args])
        want = getattr(fj, name)(*[jlimb.u64_from_numpy(v) for v in args])
        for i in range(2):
            np.testing.assert_array_equal(
                limb.to_numpy(got[i]), jlimb.u64_to_numpy(want[i]), err_msg=f"{name}[{i}]"
            )


def test_engine_choices_match_jax():
    """Shoup needs lazy mode in both packages; Solinas needs a sparse-high
    modulus in both, and is canonical (never lazy) where it is taken."""
    for pkg_mod, pkg_limb in ((jmodulus, jlimb), (modulus, limb)):
        with pytest.raises(ValueError):
            pkg_limb.FieldConsts.from_modulus(pkg_mod.Modulus(N_FLAG, 3), modmul="shoup")
        with pytest.raises(ValueError):
            pkg_limb.FieldConsts.from_modulus(pkg_mod.Modulus(N_FLAG, 3), modmul="karatsuba")
    for pkg_mod, pkg_limb in ((jmodulus, jlimb), (modulus, limb)):
        fc = pkg_limb.FieldConsts.from_modulus(pkg_mod.Modulus(N_FLAG, 3), modmul="solinas")
        assert (fc.modmul, fc.lazy, fc.n_form, fc.n_c, fc.n_s) == ("solinas", False, "high", 1827, 31)
        with pytest.raises(ValueError, match="sparse-high"):
            pkg_limb.FieldConsts.from_modulus(pkg_mod.Modulus(N_TEST, 3), modmul="solinas")
