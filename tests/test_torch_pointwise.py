"""PyTorch port, the pointwise product of two spectra
(``sventt_tpu_torch/ops/pointwise.py``), on the CPU: its plain path against
``a * b mod N`` on Python ints, word for word, its counts and its errors;
``cyclic_convolve`` through it against the golden model; the ctypes
signature against the C entry of ``csrc/pointwise.cu``.  The kernel itself
is held to the plain path bitwise on the card by ``chip_smoke.py``
(``pointwise_cases``)."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from sventt_tpu_torch.apps import cyclic_convolve, poly_multiply
from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.limb import FieldConsts, from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    Modulus,
)
from sventt_tpu_torch.ops import pointwise
from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh
from sventt_tpu_torch.plan import NTT, NttConfig

CSRC = pathlib.Path(pointwise.__file__).resolve().parent.parent / "csrc" / "pointwise.cu"

#: (name, modulus, generator): canonical 64-bit, lazy 62-bit, Solinas-capable.
MODULI = [
    ("flagship", FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR),
    ("test-lazy", TEST_MODULUS, TEST_GENERATOR),
    ("goldilocks", GOLDILOCKS_MODULUS, 7),
]


def consts(N, g):
    mod = Modulus(N, g)
    return FieldConsts.from_modulus(mod), mod.montgomery_r2


def operands(fc, shape, seed):
    """Words of ``shape`` below N (below 2N when lazy), the first ones the
    edge values 0, 1, N - 1 (and N, 2N - 1 when lazy) against each other."""
    N = fc.modulus
    top = 2 * N if fc.lazy else N
    rng = np.random.default_rng(seed)
    a = rng.integers(0, top, size=shape, dtype=np.uint64).reshape(-1)
    b = rng.integers(0, top, size=shape, dtype=np.uint64).reshape(-1)
    edges = [0, 1, N - 1] + ([N, 2 * N - 1] if fc.lazy else [])
    pairs = [(x, y) for x in edges for y in edges]
    a[: len(pairs)] = [x for x, _ in pairs]
    b[: len(pairs)] = [y for _, y in pairs]
    return a.reshape(shape), b.reshape(shape)


def want(a, b, N):
    return [int(x) * int(y) % N for x, y in zip(a.reshape(-1), b.reshape(-1))]


@pytest.mark.parametrize("shape", [(256,), (256, 4)], ids=["n", "n-by-4"])
@pytest.mark.parametrize("name,N,g", MODULI, ids=[m[0] for m in MODULI])
def test_the_plain_path_is_a_times_b_mod_n(name, N, g, shape):
    fc, r2 = consts(N, g)
    assert fc.lazy == (name == "test-lazy")
    a, b = operands(fc, shape, seed=len(shape) + N % 97)
    got = pointwise.mont_product(fc, from_numpy(a), from_numpy(b), r2)
    assert tuple(got.shape) == shape
    assert [int(v) for v in to_numpy(got).reshape(-1)] == want(a, b, N)


@pytest.mark.parametrize("name,N,g", MODULI, ids=[m[0] for m in MODULI])
def test_a_view_that_is_not_contiguous(name, N, g):
    fc, r2 = consts(N, g)
    a, b = operands(fc, (64, 8), seed=5)
    ta, tb = from_numpy(a).t(), from_numpy(b)[:, 1:7:2].t()
    assert not ta.is_contiguous() and not tb.is_contiguous()
    ta = ta[1:4]  # (3, 64), beside tb's (3, 64)
    got = pointwise.mont_product(fc, ta, tb, r2)
    assert tuple(got.shape) == (3, 64)
    assert [int(v) for v in to_numpy(got).reshape(-1)] == want(to_numpy(ta), to_numpy(tb), N)


def test_each_call_counts_one_plain_call_and_no_launch():
    fc, r2 = consts(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    x = from_numpy(np.arange(16, dtype=np.uint64))
    pointwise.reset_counts()
    for k in range(1, 4):
        pointwise.mont_product(fc, x, x, r2)
        assert pointwise.PLAIN_CALLS == {"pointwise": k}
    assert pointwise.LAUNCHES == {"pointwise": 0}
    pointwise.reset_counts()
    assert pointwise.PLAIN_CALLS == {"pointwise": 0}


@pytest.mark.parametrize("b,error", [
    (torch.zeros(8, dtype=torch.int32), TypeError),
    (torch.zeros(4, dtype=torch.int64), ValueError),
    (torch.zeros((8, 1), dtype=torch.int64), ValueError),
    (torch.zeros(8, dtype=torch.int64, device="meta"), ValueError),
], ids=["dtype", "length", "shape", "device"])
def test_a_mismatch_raises(b, error):
    fc, r2 = consts(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    with pytest.raises(error):
        pointwise.mont_product(fc, torch.zeros(8, dtype=torch.int64), b, r2)


def test_a_device_that_is_neither_cpu_nor_cuda_raises():
    fc, r2 = consts(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    x = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        pointwise.mont_product(fc, x, x, r2)


@pytest.mark.parametrize("engine", ["mxu", "pallas", "jnp"])
@pytest.mark.parametrize("name,N,g", MODULI[:2], ids=[m[0] for m in MODULI[:2]])
def test_cyclic_convolve_on_the_cpu_equals_the_golden_model(name, N, g, engine):
    n = 256
    ntt = NTT(NttConfig(N, g, n, engine=engine), device="cpu")
    rng = np.random.default_rng(n + N % 89)
    a, b = (rng.integers(0, N, n, dtype=np.uint64) for _ in range(2))
    pointwise.reset_counts()
    got = ntt.fc.normalize(cyclic_convolve(ntt, from_numpy(a), from_numpy(b)))
    assert pointwise.PLAIN_CALLS["pointwise"] == 1
    golden = GoldenNTT(n, Modulus(N, g))
    assert [int(v) for v in to_numpy(got)] == golden.cyclic_convolve(
        [int(v) for v in a], [int(v) for v in b])


def test_a_distributed_product_runs_the_step_once_a_shard():
    n, D = 1 << 10, 4
    dntt = DistributedNTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, strategy="six_step"),
                          make_ntt_mesh(devices=["cpu"] * D))
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 20, 100, dtype=np.uint64)
    b = rng.integers(0, 1 << 20, 60, dtype=np.uint64)
    pointwise.reset_counts()
    got = poly_multiply(a, b, FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, ntt=dntt)
    assert pointwise.PLAIN_CALLS["pointwise"] == D
    assert [int(v) for v in got] == [int(v) for v in np.convolve(
        a.astype(object), b.astype(object))]


def test_the_ctypes_signature_matches_the_c_entry():
    (params,) = re.findall(r'extern "C" int sventt_pointwise_mont_mul\(([^)]*)\)', CSRC.read_text())
    # "const void *a" -> "const void*": a pointer's star sits on its name
    c_types = [" ".join(p.split()[:-1]) + "*" * p.split()[-1].count("*")
               for p in params.split(",")]
    as_ctypes = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
                 "long long": ctypes.c_longlong, "int": ctypes.c_int,
                 "unsigned long long": ctypes.c_ulonglong}
    assert [as_ctypes[t] for t in c_types] == pointwise._ARGTYPES
