"""PyTorch port, the Solinas branch of the radix-2 mid and lane kernels'
plain versions (K5, K6), bitwise against the JAX package's Pallas kernels
in interpret mode, as in test_torch_solinas_kernels.py (whose helpers
this file shares).  A separate file, so that ``--dist loadfile`` gives it
its own worker.
"""

import pytest

from sventt_tpu.field.limb import u64_from_numpy
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu.ops.twiddle import MontPair as JMontPair
from sventt_tpu.plan.planner import _mont_mul_bcast
from sventt_tpu_torch.field.limb import from_numpy
from sventt_tpu_torch.ops import ntt_pallas
from sventt_tpu_torch.ops.twiddle import MontPair
from test_torch_solinas_kernels import DIRECTIONS, MODULI, _data, _same, _setup, _twiddles


@DIRECTIONS
@pytest.mark.parametrize("N,g", MODULI)
def test_mid_matches_jax(rng, N, g, inverse):
    """K5 on (4, 8, 3): bare, and with the fused Solinas twiddle against
    JAX's separate ``_mont_mul_bcast`` (its Solinas branch) before
    (forward) or after (inverse) its mid kernel."""
    jmod, mod, jfc, fc = _setup(N, g)
    jt = jpal.make_leaf_tables(jmod, 8, inverse=inverse, modmul="solinas")
    pt = ntt_pallas.make_leaf_tables(mod, 8, inverse=inverse, modmul="solinas", device="cpu")
    x = _data(rng, N, (4, 8, 3), not inverse)
    xj = u64_from_numpy(x)
    w = _twiddles(rng, N, (4, 8))
    jtw = JMontPair(u64_from_numpy(w), None)
    if inverse:
        _same(ntt_pallas.fused_ntt_mid(from_numpy(x), pt, fc), jpal.fused_ntt_mid(xj, jt, jfc))
        want = _mont_mul_bcast(jfc, jpal.fused_ntt_mid(xj, jt, jfc), jtw, 1)
    else:
        want = jpal.fused_ntt_mid(_mont_mul_bcast(jfc, xj, jtw, 1), jt, jfc)
    got = ntt_pallas.fused_ntt_mid(from_numpy(x), pt, fc, tw=MontPair(from_numpy(w), None))
    _same(got, want)


@DIRECTIONS
@pytest.mark.parametrize("N,g", MODULI)
def test_lane_matches_jax(rng, N, g, inverse):
    """K6 on (5, 16) rows with the Solinas twiddle in the data's layout
    (apply_pre: prologue forward, epilogue inverse)."""
    jmod, mod, jfc, fc = _setup(N, g)
    jt = jpal.make_lane_tables(jmod, 16, inverse=inverse, modmul="solinas")
    pt = ntt_pallas.make_lane_tables(mod, 16, inverse=inverse, modmul="solinas", device="cpu")
    x = _data(rng, N, (5, 16), not inverse)
    w = _twiddles(rng, N, (5, 16))
    want = jpal.fused_ntt_lane(u64_from_numpy(x), jt, jfc, pre_tw=JMontPair(u64_from_numpy(w), None))
    _same(ntt_pallas.fused_ntt_lane(from_numpy(x), pt, fc, pre_tw=MontPair(from_numpy(w), None)), want)
