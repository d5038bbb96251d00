"""PyTorch port, the radix-2^R grouped lane kernel (K8), and the grouped
leaf kernel (K7) at m = 32: the plain versions bitwise against
sventt_tpu.ops.ntt_pallas.

As in test_torch_ntt_grouped.py (whose helpers this file shares): the JAX
side runs its Pallas kernels in interpret mode, inputs are made with numpy
from a seed and hold an N-1 column, and the tolerance is zero, before
normalize and after it.  A separate file, so that ``--dist loadfile`` gives
it its own worker.
"""

import numpy as np
import pytest

from sventt_tpu.field.limb import u64_from_numpy
from sventt_tpu.ops import ntt_pallas as jpal
from sventt_tpu_torch.field.limb import from_numpy, to_numpy
from sventt_tpu_torch.ops import ntt_pallas
from test_torch_ntt_grouped import FLAG, MONT, SHOUP, _specs_as_tuples
from test_torch_ntt_pallas import DIRECTIONS, _assert_same, _data, _jax_pair, _port_pair, _setup, _twiddles

# (engine, m, max_r, fused inter-step twiddle): each case traces one JAX
# kernel per direction (~2-4 s)
LANE_CASES = [
    *[pytest.param(*SHOUP, 8, 3, mode, id=f"test62-shoup-8-r3-{mode}")
      for mode in (None, "pair", "w")],
    pytest.param(*FLAG, 64, 2, "pair", id="flagship-64-r2-pair"),
    pytest.param(*MONT, 256, 3, "w", id="test62-mont-256-r3-w"),
    pytest.param(*FLAG, 256, 4, None, id="flagship-256-r4"),
]


@pytest.mark.parametrize("N,g,modmul,m,max_r,mode", LANE_CASES)
@DIRECTIONS
def test_grouped_lane_matches_jax(rng, N, g, modmul, m, max_r, mode, inverse):
    """K8 on (5, m) rows (ragged against the JAX kernel's 64-row blocks),
    against JAX fused_ntt_lane on its grouped tables, with no inter-step
    twiddle, the "pair" one or the companion-free "w" one."""
    jmod, mod, jfc, fc = _setup(N, g, modmul)
    jt = jpal.make_lane_tables(jmod, m, inverse=inverse, modmul=modmul, max_r=max_r)
    pt = ntt_pallas.make_lane_tables(
        mod, m, inverse=inverse, modmul=modmul, max_r=max_r, device="cpu"
    )
    assert isinstance(pt, ntt_pallas.GroupedLaneDirection)
    assert _specs_as_tuples(pt.specs) == _specs_as_tuples(jt.specs)
    x = _data(rng, N, (5, m), 0)
    jtw = ptw = None
    if mode is not None:
        w, wp = _twiddles(rng, N, (5, m), mode)
        jtw, ptw = _jax_pair(w, wp), _port_pair(w, wp)
    want = jpal.fused_ntt_lane(u64_from_numpy(x), jt, jfc, pre_tw=jtw)
    ntt_pallas.reset_counts()
    got = ntt_pallas.fused_ntt_lane(from_numpy(x), pt, fc, pre_tw=ptw)
    assert ntt_pallas.PLAIN_CALLS["lane_grouped"] == 1 and not any(ntt_pallas.LAUNCHES.values())
    _assert_same(got, want, jfc, fc, str(mode))
    plain = ntt_pallas.lane_grouped_plain(from_numpy(x), pt, fc, pre_tw=ptw)
    np.testing.assert_array_equal(to_numpy(plain), to_numpy(got))


def test_grouped_leaf_m32_matches_jax(rng):
    """K7 at m = 32, max_r = 3 (groups 3 + 2), forward: the JAX kernel
    takes ~20 s to trace at this length, so one direction (the inverse is
    held against GoldenNTT at m = 64 and 256 in test_torch_ntt_grouped.py)."""
    jmod, mod, jfc, fc = _setup(*FLAG)
    jt = jpal.make_leaf_tables(jmod, 32, inverse=False, max_r=3)
    pt = ntt_pallas.make_leaf_tables(mod, 32, inverse=False, max_r=3, device="cpu")
    assert [s.R for s in pt.specs] == [3, 2]
    x = _data(rng, FLAG[0], (32, 3), 1)
    _assert_same(ntt_pallas.fused_ntt(from_numpy(x), pt, fc),
                 jpal.fused_ntt(u64_from_numpy(x), jt, jfc), jfc, fc)
