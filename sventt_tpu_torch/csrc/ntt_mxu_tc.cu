// The s8 matrix NTT on Hopper's int8 tensor cores: the instantiations of
// csrc/mxu_tc.cuh for the s8 digit stack (schemes "s8" and "s8b"), K1 lead,
// K2 mid and K3 lane on every plan's path.  The kernel, its design and its
// bound are in that header; the u7 planes' instantiations are
// csrc/ntt_mxu_tc_u7.cu.

#include "mxu_tc.cuh"

// The s8 digit stack (schemes "s8" and "s8b") in the ring-tile layout of
// ops/ntt_mxu.py::tc_plane_tiles, with corr; the arguments of
// sventt_mxu_ntt less u7, plus the form (`lane`: 0 the strided view, 1
// the lane layout, 2 the lane layout with the staged epilogue, for the
// inverse with the pair twiddle only; the lane forms take
// A = 1, sm = 1, sb = m, a twiddle in the same layout and 16-byte aligned
// pointers) and the launch geometry of
// ops/ntt_mxu.py::tc_geometry: nt columns a block (8, 16, 32 or 64), the
// row split (gridDim.z) and the dynamic shared memory, which must be the
// geometry's own.
extern "C" int sventt_mxu_ntt_tc(
    const void *x, void *out, const void *tiles, const void *corr, const void *tw_w,
    const void *tw_wp, long long A, int m, long long B, long long sa, long long sm,
    long long sb, long long ta, long long tm, long long tb, int tw_mode, int inverse,
    int lazy, unsigned long long N, unsigned long long nprime, unsigned long long c128,
    unsigned long long mu, unsigned long long ninv, int nsub, int barrett, int lane, int nt,
    int split, long long smem, void *stream) {
  return entry<false, true>(x, out, tiles, corr, tw_w, tw_wp, A, m, B, sa, sm, sb, ta, tm, tb,
                            tw_mode, inverse, lazy, N, nprime, c128, mu, ninv, nsub, barrett,
                            lane, nt, split, smem, stream);
}
