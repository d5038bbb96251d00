"""PyTorch port, K11 (the fused u7 prototype of the matrix NTT): bitwise
against the body of experimental/mxu_fused_kernel.py and the golden model.

The JAX file times itself when it runs, so the test runs its definitions
(everything before the timing tail) into a namespace and calls its kernel
body through ``pl.pallas_call(..., interpret=True)`` on a (128, 256) block:
two grid steps of its (128, 128) tiles.  Nothing in ``experimental/``
changes.  Inputs are made with numpy from a seed; the tolerance is zero.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from sventt_tpu_torch.experimental import mxu_fused_kernel as fused
from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.limb import from_numpy, to_numpy
from sventt_tpu_torch.field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS, Modulus
from sventt_tpu_torch.ops import ntt_mxu

REPO = pathlib.Path(__file__).resolve().parents[1]
K11_SOURCE = REPO / "experimental" / "mxu_fused_kernel.py"
R = 128
CARRY_COL = R  # the constructed column, first of the second tile
CARRY_ROW = 1


def _k11_namespace() -> dict:
    """The definitions of the JAX prototype: its source up to the timing
    tail, run in a fresh namespace (``sys.path`` restored afterwards)."""
    src = K11_SOURCE.read_text()
    tail = src.index("\nt0 = time.perf_counter()")
    ns = {"__name__": "k11_definitions"}
    saved = list(sys.path)
    try:
        exec(compile(src[:tail], str(K11_SOURCE), "exec"), ns)
    finally:
        sys.path[:] = saved
    return ns


def _carry_column(N: int) -> np.ndarray:
    """A column of 128 canonical values whose output row 1 takes the carry
    out of the high word after the fold: the exact sum sum_j M[1, j] x_j
    lies within R64 below 2^129 (top word 1, high word all ones, and the
    fold's low-word add carries).  Greedy: x_j = N - 1 from j = 1 on while
    that stays below the target, then the remainder, then column 0, whose
    entry is R64 (~2^42 < 2^128 mod N), fills it."""
    M = ntt_mxu._lifted_matrix(N, FLAGSHIP_GENERATOR, R, False, 1)
    target, r64 = (1 << 129) - 1, (1 << 64) % N
    x = [0] * R
    rem = target
    for j in range(1, R):
        c = int(M[CARRY_ROW, j])
        x[j] = min(N - 1, rem // c)
        rem -= c * x[j]
        if rem < c:
            break
    assert int(M[CARRY_ROW, 0]) == r64
    x[0] = rem // r64
    return np.array(x, dtype=np.uint64)


@pytest.fixture(scope="module")
def k11():
    """(input (128, 256), K11's output, the K11 namespace): random values
    with an N-1 column, and the carry column at CARRY_COL."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    ns = _k11_namespace()
    N = ns["N"]
    x = np.random.default_rng(11).integers(0, N, (R, 2 * R), dtype=np.uint64)
    x[:, 3] = N - 1
    x[:, CARRY_COL] = _carry_column(N)
    call = pl.pallas_call(
        ns["kernel"],
        out_shape=[jax.ShapeDtypeStruct((R, 2 * R), jnp.uint32)] * 2,
        grid=(2,),
        in_specs=[ns["x_spec"], ns["x_spec"], ns["m_spec"]],
        out_specs=[ns["x_spec"]] * 2,
        interpret=True,
    )
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = x.astype(np.uint32)
    oh, ol = call(jnp.asarray(hi), jnp.asarray(lo), ns["M_stack"])
    out = (np.asarray(oh).astype(np.uint64) << np.uint64(32)) | np.asarray(ol).astype(np.uint64)
    return x, out, ns


def _port(x):
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    stack = fused.make_fused_stack(mod, device="cpu")
    return to_numpy(fused.mxu_fused_ntt(from_numpy(x), stack, mod))


def test_fused_stack_equals_k11(k11):
    """make_fused_stack is K11's (1280, 128) M_stack, and the u7 planes."""
    _, _, ns = k11
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    assert ns["N"] == mod.modulus and ns["NL"] == ntt_mxu.NL
    stack = fused.make_fused_stack(mod, device="cpu")
    assert stack.dtype == torch.int8 and tuple(stack.shape) == (ntt_mxu.NL * R, R)
    np.testing.assert_array_equal(stack.numpy(), np.asarray(ns["M_stack"]))
    t = ntt_mxu.make_mxu_tables(mod, R, inverse=False, scheme="u7", device="cpu")
    assert torch.equal(stack, t.planes)


def test_fused_matches_k11_body(k11):
    """The port equals K11's own Pallas body bitwise on every column but the
    constructed one, and the golden model on a few."""
    x, want, ns = k11
    got = _port(x)
    keep = np.arange(x.shape[1]) != CARRY_COL
    np.testing.assert_array_equal(got[:, keep], want[:, keep])
    golden = GoldenNTT(R, Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR))
    for col in (0, 3, 77, 255):
        assert [int(v) for v in got[:, col]] == golden.forward([int(v) for v in x[:, col]])


def test_fused_carry_divergence(k11):
    """On the constructed column K11 drops the high word's carry and is off
    at output row 1 only; the port folds it back (``_mxu_body``'s tail) and
    equals the golden model."""
    x, want, _ = k11
    golden = GoldenNTT(R, Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR))
    ref = golden.forward([int(v) for v in x[:, CARRY_COL]])
    got = _port(x)
    assert [int(v) for v in got[:, CARRY_COL]] == ref
    k11_col = [int(v) for v in want[:, CARRY_COL]]
    assert [p for p in range(R) if k11_col[p] != ref[p]] == [CARRY_ROW]


def test_fused_counts_and_rejects():
    """CPU tensors count plain calls, never launches; on a CUDA tensor K11
    runs the u7 lead form's kernel, the tensor-core one; a stack or data of
    the wrong shape raises; importing the module computed nothing."""
    assert not any(isinstance(v, torch.Tensor) for v in vars(fused).values())
    assert ntt_mxu.kernel_for("u7", "lead") == "tensor_core"
    mod = Modulus(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR)
    stack = fused.make_fused_stack(mod, R=16, device="cpu")
    x = from_numpy(np.random.default_rng(3).integers(0, mod.modulus, (16, 5), dtype=np.uint64))
    fused.reset_counts()
    got = fused.mxu_fused_ntt(x, stack, mod)
    assert fused.PLAIN_CALLS == {"fused": 1} and fused.LAUNCHES == {"fused": 0}
    assert torch.equal(got, fused.mxu_fused_plain(x, stack, mod))
    assert fused.PLAIN_CALLS == {"fused": 1}
    golden = GoldenNTT(16, mod)
    assert [int(v) for v in to_numpy(got)[:, 4]] == golden.forward([int(v) for v in to_numpy(x)[:, 4]])
    with pytest.raises(ValueError):
        fused.mxu_fused_ntt(x[:8], stack, mod)
    with pytest.raises(ValueError):
        fused.mxu_fused_ntt(x, stack[:80], mod)
    with pytest.raises(ValueError):
        fused.mxu_fused_ntt(x, stack.to(torch.int16), mod)
