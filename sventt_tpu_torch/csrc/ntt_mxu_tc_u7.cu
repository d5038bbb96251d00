// The u7 matrix NTT on Hopper's int8 tensor cores: the instantiations of
// csrc/mxu_tc.cuh for the u7 planes, K1 lead, K2 mid and K3 lane of
// make_mxu_tables(scheme="u7") tables and K11
// (sventt_tpu_torch/experimental/mxu_fused_kernel.py, the lead form at
// m = 128).  The kernel, its design and its bound are in that header; the
// s8 digit stack's instantiations are csrc/ntt_mxu_tc.cu.  Ten 7-bit
// planes of the matrix times ten of the data: 100 products a point and
// matrix entry against s8's 64, so no plan runs u7 (as in the JAX
// package); the ops-level entry points and K11 do.

#include "mxu_tc.cuh"

// The u7 planes (10m, m) in the ring-tile layout of
// ops/ntt_mxu.py::tc_plane_tiles; the arguments of sventt_mxu_ntt_tc, corr
// unread (it may be null), and the u7 launch geometry of
// ops/ntt_mxu.py::tc_geometry(..., scheme="u7").
extern "C" int sventt_mxu_ntt_tc_u7(
    const void *x, void *out, const void *tiles, const void *corr, const void *tw_w,
    const void *tw_wp, long long A, int m, long long B, long long sa, long long sm,
    long long sb, long long ta, long long tm, long long tb, int tw_mode, int inverse,
    int lazy, unsigned long long N, unsigned long long nprime, unsigned long long c128,
    unsigned long long mu, unsigned long long ninv, int nsub, int barrett, int lane, int nt,
    int split, long long smem, void *stream) {
  return entry<true, false>(x, out, tiles, corr, tw_w, tw_wp, A, m, B, sa, sm, sb, ta, tm, tb,
                            tw_mode, inverse, lazy,
                            Consts{N, nprime, c128, mu, ninv, nsub, barrett}, Limbs{}, lane, nt,
                            split, smem, stream);
}
