"""PyTorch port, the radix-2 mid and lane kernels (K5, K6): the plain
versions bitwise against sventt_tpu.ops.ntt_pallas.

As in test_torch_ntt_pallas.py (whose helpers this file shares): the JAX
side runs its Pallas kernels in interpret mode, inputs are made with numpy
from a seed and hold an N-1 column, and the tolerance is zero, before
normalize and after it.  A separate file, so that ``--dist loadfile``
gives it its own worker.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import u64_from_numpy
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu.plan.planner import _mont_mul_bcast
from sventt_tpu_torch.field.limb import from_numpy, to_numpy
from sventt_tpu_torch.ops import ntt_pallas
from test_torch_ntt_pallas import (
    DIRECTIONS,
    ENGINES,
    _assert_same,
    _data,
    _jax_pair,
    _port_pair,
    _setup,
    _twiddles,
)


@DIRECTIONS
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_fused_ntt_mid_matches_jax(rng, N, g, modmul, inverse):
    """K5 on (4, 16, 3): bare against JAX fused_ntt_mid; with the fused
    inter-step twiddle ("pair", "w") against JAX's separate
    _mont_mul_bcast before (forward) or after (inverse) fused_ntt_mid."""
    jmod, mod, jfc, fc = _setup(N, g, modmul)
    jt = jpal.make_leaf_tables(jmod, 16, inverse=inverse, modmul=modmul)
    pt = ntt_pallas.make_leaf_tables(mod, 16, inverse=inverse, modmul=modmul, device="cpu")
    x = _data(rng, N, (4, 16, 3), 2)
    xj = u64_from_numpy(x)
    _assert_same(ntt_pallas.fused_ntt_mid(from_numpy(x), pt, fc), jpal.fused_ntt_mid(xj, jt, jfc),
                 jfc, fc, "bare")
    for mode in ("pair", "w"):
        w, wp = _twiddles(rng, N, (4, 16), mode)
        jtw = _jax_pair(w, wp)
        if inverse:
            want = _mont_mul_bcast(jfc, jpal.fused_ntt_mid(xj, jt, jfc), jtw, 1)
        else:
            want = jpal.fused_ntt_mid(_mont_mul_bcast(jfc, xj, jtw, 1), jt, jfc)
        got = ntt_pallas.fused_ntt_mid(from_numpy(x), pt, fc, tw=_port_pair(w, wp))
        _assert_same(got, want, jfc, fc, mode)
        plain = ntt_pallas.mid_plain(from_numpy(x), pt, fc, tw=_port_pair(w, wp))
        np.testing.assert_array_equal(to_numpy(plain), to_numpy(got))


@DIRECTIONS
@pytest.mark.parametrize("N,g,modmul", ENGINES)
def test_fused_ntt_lane_matches_jax(rng, N, g, modmul, inverse):
    """K6 on (5, 16) rows: pre_tw "pair" and "w", and none."""
    jmod, mod, jfc, fc = _setup(N, g, modmul)
    jt = jpal.make_lane_tables(jmod, 16, inverse=inverse, modmul=modmul)
    pt = ntt_pallas.make_lane_tables(mod, 16, inverse=inverse, modmul=modmul, device="cpu")
    x = _data(rng, N, (5, 16), 0)
    # each mode is a separate JAX kernel to trace: the bare one on one engine
    for mode in ("pair", "w") + ((None,) if modmul == "shoup" else ()):
        jtw = ptw = None
        if mode is not None:
            w, wp = _twiddles(rng, N, (5, 16), mode)
            jtw, ptw = _jax_pair(w, wp), _port_pair(w, wp)
        want = jpal.fused_ntt_lane(u64_from_numpy(x), jt, jfc, pre_tw=jtw)
        got = ntt_pallas.fused_ntt_lane(from_numpy(x), pt, fc, pre_tw=ptw)
        _assert_same(got, want, jfc, fc, str(mode))
