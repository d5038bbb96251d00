// The s8 matrix NTT on Hopper's int8 tensor cores for a multi-modular call:
// the LIMBS instantiations of csrc/mxu_tc.cuh, which carry every limb of an
// RNS transform (one modulus a limb) in one launch, K1 lead, K2 mid and K3
// lane: each of the strided and lane forms' 9 modes (no twiddle, pair and
// w in both directions, lazy or not) and the staged lane epilogue's pair
// inverse, not lazy (lazy, it spilled 16 bytes; the lane form runs that
// one); no Solinas.  A source of its own, so that nvcc builds it beside
// csrc/ntt_mxu_tc.cu.

#include "mxu_tc.cuh"

// The arguments of sventt_mxu_ntt_tc with the limbs in place of the one
// modulus's constants: `table` the (L, 8) limb table on the device
// (field/limb.py::LIMB_COLUMNS), `apl` the A slices a limb (slice a is
// limb a / apl; the lane forms take apl = 1, the limbs' rows at an even
// stride sa, and ta likewise), `tile_bytes` one limb's planes in the
// ring-tile layout of ops/ntt_mxu.py::tc_plane_tiles (the limbs' one after
// another, as `corr`'s m words a limb).
extern "C" int sventt_mxu_ntt_tc_limbs(
    const void *x, void *out, const void *tiles, const void *corr, const void *tw_w,
    const void *tw_wp, long long A, int m, long long B, long long sa, long long sm,
    long long sb, long long ta, long long tm, long long tb, int tw_mode, int inverse,
    int lazy, const void *table, long long apl, long long tile_bytes, int lane, int nt,
    int split, long long smem, void *stream) {
  return entry<false, true, true>(
      x, out, tiles, corr, tw_w, tw_wp, A, m, B, sa, sm, sb, ta, tm, tb, tw_mode, inverse, lazy,
      Consts{}, Limbs{(const unsigned long long *)table, apl, tile_bytes}, lane, nt, split, smem,
      stream);
}
