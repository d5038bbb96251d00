// Radix-2^R grouped NTT for Hopper (sm_90a): one kernel, two orientations.
//
// Replaces the Pallas kernels of sventt_tpu/ops/ntt_pallas.py that the
// engine "pallas" runs with max_r > 1:
//   K7 :688 _grouped_call (body _make_grouped_kernel :584): one radix-2^R
//      group along axis 0 of (m, B), one pallas_call per group -- every
//      leaf, and every inner row step (the planner's transpose fallback);
//   K8 :1124 _lane_grouped_call (body _lane_grouped_kernel :1051): every
//      group along the last axis of (rows, m), partners found by lane
//      rolls, the inter-step twiddle fused -- the unbatched root row step.
// The plain PyTorch version is sventt_tpu_torch/ops/ntt_pallas.py::
// _groups_plain; the two agree bit for bit.
//
// What bounds it on the H100: 16 bytes a point (32 with a "pair" twiddle of
// the data's size, as the lane root step has: 0.080 / 0.160 ms at 2^24)
// against, per point, about one combined-table multiply per group and a
// constant multiply on part of the ranks' differences -- at m = 256,
// max_r = 3, 4 Montgomery products a point (4.5 with K8's twiddle), each
// a run of 32-bit multiplies on the integer multiply pipe (half the FP32
// rate; tools/grouped_ablation.py measures the product's rate on the
// card), and 8 ranks of 64-bit modular additions.  The kernel is bound by
// its instruction count, not by HBM: without device memory traffic it is
// no faster, without the products a third faster (PERF.md,
// tools/grouped_ablation.py).
//
// The design (grouped_reg_kernel), one launch a leaf, all groups inside:
// * A group's butterfly set lives in registers.  Group g of R ranks, row
//   unit L (forward L = m >> (s0 + R), inverse L = 2^s0, s0 the stages
//   before it), couples the 2^R points base + k L, k < 2^R, base = hi *
//   span + lo (span = 2^R L, lo < L).  One thread holds them (v[], at most
//   16 words, R a template parameter) and runs all R ranks with no shared
//   memory and no barrier: forward rank s pairs k and k + 2^(R-1-s),
//   inverse rank s pairs k and k + 2^s.
// * One exchange per group boundary.  A block copies its tile (and, fused,
//   its inter-step twiddles) from device memory into shared memory with
//   cp.async, consecutive threads on consecutive addresses in either
//   orientation, so every device read is coalesced and no register holds
//   an address; each group then reads its sets from the tile once and
//   writes them back once, a barrier between groups; the last group
//   writes device memory straight from registers (the leaf's lanes on
//   neighbouring columns; the lane's on neighbouring set indices, lo
//   fastest), the fused inverse twiddle first.  At m = 256, max_r = 3 that
//   is 3 tile passes where the rank-by-rank kernel made 10.  The lane
//   tile's word w = c m + j (and the leaf's w = j C + c below 16 columns a
//   tile) sits at w ^ SWIZZLE[(w >> 4) & 15]: a permutation inside each
//   16-word (128-byte) line that keeps every half-warp's 8-byte accesses
//   on 16 distinct bank pairs for every (R, L) where a half-warp lies in
//   one row; from 16 columns on the leaf needs none (the CPU test
//   tests/test_torch_ntt_grouped_regs.py checks all of them).
// * Constants hoisted out of the butterfly.  Within a group the constant
//   of rank s depends on (s, low = k mod the rank's pair distance) only,
//   and the combined table on j mod span only (GroupSpec.span, its row
//   period): a block stages every group's constant pairs, its presence
//   mask as one 32-bit word, and one span of its table as 16-byte (w, wp)
//   pairs in shared memory once, then walks tiles (grid = resident blocks,
//   each looping over (slice, tile) work).  A warp reads a constant
//   uniformly; the leaf reads a table entry uniformly, the lane
//   contiguously or as a broadcast.
// * Geometry: ops/ntt_pallas.py::grouped_geometry chooses the batch
//   entries a tile (C) and the threads a batch entry (Q), C Q <= 256: the
//   leaf 32 columns (8 threads each at m = 256), the lane Q = the widest
//   group's set count (C = 8 rows at m = 256); C halves while the tile
//   exceeds a third of an SM's shared memory and until the grid has two
//   blocks an SM or the leaf reaches 4 columns (the 2^17 plan's launches).
//   The C entry recomputes the shared-memory layout and refuses any other.
//   Template parameters keep registers in check: groups of up to 3 ranks
//   (8 words a thread) compile for three blocks of 256 threads an SM, of
//   4 for two (reg_blocks), with no spill.
// Per butterfly, as before and as the plain version:
//   forward  (x0 + x1, c * (x0 - x1)) -- K7 biases a lazy difference by
//            +2N unreduced where a constant follows, K8 (LANE) reduces it
//            with sub; last rank: y0 *= tab[j0], y1 *= tab[j0 + h]
//   inverse  first rank: x0 *= tab[j0], t = x1 * tab[j0 + h]; later ranks:
//            t = c * x1; then (x0 + t, x0 - t)
// K7 skips the table multiply on a first point whose combined exponent is
// 0 (k = 0), unless the group holds the inverse 1/m; K8 multiplies every
// point.  Stage and constant multiplies are Montgomery or Shoup (template
// MM); the fused inter-step twiddle is Montgomery (as field.cuh
// inter_step_mul, tw_mode 1 or 2).  Solinas never reaches this kernel: it
// forces max_r = 1.
//
// grouped_ranks_kernel, below it, is the first port's schedule (a whole
// tile in shared memory, one thread per butterfly per rank, a barrier
// after every rank); no path runs it: chip_smoke.py times it beside the
// register kernel (ntt_pallas._launch_grouped_ranks).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "reg_tile.cuh"

namespace {

constexpr int MAX_R = 4;                    // ranks a group may have
constexpr int MAX_LOWS = 1 << (MAX_R - 1);  // constants a rank may have
constexpr int CONSTS = MAX_R * MAX_LOWS;    // constant slots a group
constexpr int MAX_GROUPS = 12;
constexpr int REG_THREADS = 256;            // the register kernel's largest block

struct RegArgs {
  const long long *x;
  long long *out;
  const unsigned long long *tab, *tabp, *cst;
  const unsigned char *cmask;
  const long long *tw_w, *tw_wp;
  long long A, B, sa, sm, sb, ta, tm, tb;
  unsigned long long ranks;
  u64 N, ninv;
  int log2m, ngroups, log2c, log2q, tw_mode, tw_words, tile_words, tab_entries;
};

// Tile `wk` (slice a, batch entries c0 ...) into the tile D and, with a
// fused twiddle, its twiddles into W / WP: word idx of the tile (leaf
// j C + c, lane c m + j) from device memory to slot(idx), consecutive
// threads on consecutive addresses (leaf along a row of columns, lane
// along a row); zeros past B.  Waits for its own copies.
template <bool LANE, bool SWZ>
__device__ __forceinline__ void load_tile(const RegArgs &p, u64 *D, u64 *W, u64 *WP,
                                          long long a, long long c0) {
  for (int idx = threadIdx.x; idx < p.tile_words; idx += blockDim.x) {
    const int c = LANE ? idx >> p.log2m : idx & ((1 << p.log2c) - 1);
    const int j = LANE ? idx & ((1 << p.log2m) - 1) : idx >> p.log2c;
    const long long col = c0 + c;
    const bool ok = col < p.B;
    const int s = slot<SWZ>(idx);
    cp_async8(D + s, p.x + (ok ? a * p.sa + j * p.sm + col * p.sb : 0), ok);
    if (p.tw_words != 0) {
      const long long t = ok ? a * p.ta + j * p.tm + col * p.tb : 0;
      cp_async8(W + s, p.tw_w + t, ok);
      if (p.tw_words == 2) cp_async8(WP + s, p.tw_wp + t, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n"
               "cp.async.wait_group 0;\n" ::
                   : "memory");
}

// Group g (R ranks, row unit 2^log2L) on every set this thread owns, in
// the tile T (tw / twp: the tile's twiddles): read the set, run the ranks
// (the forward twiddle first in the first group), write it back, or for
// the last group (`to_mem`; the inverse twiddle last) to device memory.
// `tb`: the group's staged table span; `cs`: its constant pairs; `mask`:
// bit s * MAX_LOWS + low set where rank s, sub-slice low has a constant.
template <int R, bool INV, int MM, bool LAZY, bool LANE, bool SWZ>
__device__ __forceinline__ void run_group(const RegArgs &p, u64 *T, const u64 *tw,
                                          const u64 *twp, const ulonglong2 *tb,
                                          const ulonglong2 *cs, unsigned mask, int log2L,
                                          bool first, bool to_mem, bool scaled, int q, int c,
                                          long long a, long long col) {
  constexpr int K = 1 << R;
  const u64 N = p.N;
  const int L = 1 << log2L;
  const int nsets = 1 << (p.log2m - R);
  const int Q = 1 << p.log2q;
  // tile word of point j: leaf (j, c) at j C + c, lane (c, j) at c m + j;
  // slots are recomputed where they are used again (cheaper than the
  // registers that keeping them would take)
  const int wbase = LANE ? c << p.log2m : c;
  const int wshift = LANE ? 0 : p.log2c;
#define SVENTT_SLOT(k) slot<SWZ>(wbase + ((base + (k) * L) << wshift))
  for (int set = q; set < nsets; set += Q) {
    const int lo = set & (L - 1);
    const int base = set_base(set, log2L, R);
    u64 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = T[SVENTT_SLOT(k)];
    if (!INV && first && p.tw_mode == 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int sk = SVENTT_SLOT(k);
        v[k] = mont_mul(v[k], tw[sk], twp[sk], N, LAZY);
      }
    } else if (!INV && first && p.tw_mode == 2) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = mont_mul_full(v[k], tw[SVENTT_SLOT(k)], N, p.ninv, LAZY);
    }

    if (!INV) {
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int half = 1 << (R - 1 - s);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & half) continue;
          const int k1 = k + half;
          const int low = k & (half - 1);
          const u64 x0 = v[k], x1 = v[k1];
          u64 y0 = add_mod(x0, x1, N, LAZY);
          u64 d;
          if ((mask >> (s * MAX_LOWS + low)) & 1u) {
            const ulonglong2 w = cs[s * MAX_LOWS + low];
            d = (LAZY && !LANE) ? x0 - x1 + 2 * N : sub_mod(x0, x1, N, LAZY);
            d = twiddle_mul<MM>(d, w.x, w.y, N, LAZY);
          } else {
            d = sub_mod(x0, x1, N, LAZY);
          }
          if (s == R - 1) {  // the combined table, fused into the last rank
            if (LANE || k != 0) {
              const ulonglong2 w = tb[k * L + lo];
              y0 = twiddle_mul<MM>(y0, w.x, w.y, N, LAZY);
            }
            const ulonglong2 w = tb[k1 * L + lo];
            d = twiddle_mul<MM>(d, w.x, w.y, N, LAZY);
          }
          v[k] = y0;
          v[k1] = d;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int half = 1 << s;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & half) continue;
          const int k1 = k + half;
          const int low = k & (half - 1);
          u64 x0 = v[k];
          u64 t = v[k1];
          if (s == 0) {  // the combined table, fused into the first rank
            if (LANE || scaled || k != 0) {
              const ulonglong2 w = tb[k * L + lo];
              x0 = twiddle_mul<MM>(x0, w.x, w.y, N, LAZY);
            }
            const ulonglong2 w = tb[k1 * L + lo];
            t = twiddle_mul<MM>(t, w.x, w.y, N, LAZY);
          } else if ((mask >> (s * MAX_LOWS + low)) & 1u) {
            const ulonglong2 w = cs[s * MAX_LOWS + low];
            t = twiddle_mul<MM>(t, w.x, w.y, N, LAZY);
          }
          v[k] = add_mod(x0, t, N, LAZY);
          v[k1] = sub_mod(x0, t, N, LAZY);
        }
      }
    }

    if (to_mem) {
      if (INV && p.tw_mode == 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int sk = SVENTT_SLOT(k);
          v[k] = mont_mul(v[k], tw[sk], twp[sk], N, LAZY);
        }
      } else if (INV && p.tw_mode == 2) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = mont_mul_full(v[k], tw[SVENTT_SLOT(k)], N, p.ninv, LAZY);
      }
      if (col < p.B) {
        long long *dst = p.out + a * p.sa + col * p.sb + base * p.sm;
        const long long Lsm = (long long)L * p.sm;
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k * Lsm] = (long long)v[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) T[SVENTT_SLOT(k)] = v[k];
    }
  }
#undef SVENTT_SLOT
}

// Blocks of 256 threads an SM whose registers the compiler must fit, by
// the points a thread holds (groups of up to RMAX ranks: 8 or 16): three
// at 8, two at 16; one fewer where a lazy butterfly's biased difference
// or the swizzled leaf needs more -- each the most that compiles without
// a spill.
template <int RMAX, bool INV, bool LAZY, bool LANE, bool SWZ>
constexpr int reg_blocks() {
  return RMAX <= 3 ? (LAZY || (SWZ && !LANE) ? 2 : 3)
                   : ((LAZY && !INV && LANE) || (SWZ && !LANE) ? 1 : 2);
}

// RMAX: the most ranks a group of the call has (3 or 4: 8 or 16 points a
// thread).  SWZ: the tile is swizzled (slot()); the leaf needs it only
// below 16 columns a tile, where a half-warp spans several points.
template <bool INV, int MM, bool LAZY, bool LANE, int RMAX, bool SWZ>
__global__ void __launch_bounds__(REG_THREADS, reg_blocks<RMAX, INV, LAZY, LANE, SWZ>())
    grouped_reg_kernel(const RegArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the tile, each twiddle word's tile, the tables
  u64 *D = reinterpret_cast<u64 *>(smem);
  u64 *W = D + p.tile_words;
  u64 *WP = W + p.tile_words;
  ulonglong2 *TB = reinterpret_cast<ulonglong2 *>(D + (1 + p.tw_words) * p.tile_words);
  ulonglong2 *CS = TB + p.tab_entries;
  unsigned *MK = reinterpret_cast<unsigned *>(CS + p.ngroups * CONSTS);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int g = 0, s0 = 0, off = 0; g < p.ngroups; ++g) {
    const int R = (int)((p.ranks >> (4 * g)) & 15);
    const int span = 1 << (INV ? s0 + R : p.log2m - s0);
    const long long row = (long long)g << p.log2m;
    for (int e = tid; e < span; e += nt)
      TB[off + e] = make_ulonglong2(__ldg(p.tab + row + e), __ldg(p.tabp + row + e));
    off += span;
    s0 += R;
  }
  for (int i = tid; i < p.ngroups * CONSTS; i += nt)
    CS[i] = make_ulonglong2(__ldg(p.cst + 2 * i), __ldg(p.cst + 2 * i + 1));
  for (int g = tid; g < p.ngroups; g += nt) {
    unsigned w = 0;
    for (int i = 0; i < CONSTS; ++i) w |= (unsigned)(__ldg(p.cmask + g * CONSTS + i) != 0) << i;
    MK[g] = w;
  }

  const int q = LANE ? tid & ((1 << p.log2q) - 1) : tid >> p.log2c;
  const int c = LANE ? tid >> p.log2q : tid & ((1 << p.log2c) - 1);
  const long long tiles = (p.B + (1ll << p.log2c) - 1) >> p.log2c;
  const long long work = tiles * p.A;
  for (long long wk = blockIdx.x; wk < work; wk += gridDim.x) {
    const long long a = wk / tiles;
    const long long c0 = (wk - a * tiles) << p.log2c;
    __syncthreads();  // the previous tile is done with the buffers
    load_tile<LANE, SWZ>(p, D, W, WP, a, c0);
    __syncthreads();  // the tile (and the tables) are in shared memory
    for (int g = 0, s0 = 0, off = 0; g < p.ngroups; ++g) {
      const int R = (int)((p.ranks >> (4 * g)) & 15);
      const int log2L = INV ? s0 : p.log2m - s0 - R;
      const bool first = g == 0, last = g == p.ngroups - 1;
      if (!first) __syncthreads();  // the previous group's sets are in the tile
      const ulonglong2 *tb = TB + off;
      const ulonglong2 *cs = CS + g * CONSTS;
      const unsigned mask = MK[g];
      const bool scaled = INV && last;
      if (R == 1)
        run_group<1, INV, MM, LAZY, LANE, SWZ>(p, D, W, WP, tb, cs, mask, log2L, first, last,
                                               scaled, q, c, a, c0 + c);
      else if (R == 2)
        run_group<2, INV, MM, LAZY, LANE, SWZ>(p, D, W, WP, tb, cs, mask, log2L, first, last,
                                               scaled, q, c, a, c0 + c);
      else if (RMAX < 4 || R == 3)
        run_group<3, INV, MM, LAZY, LANE, SWZ>(p, D, W, WP, tb, cs, mask, log2L, first, last,
                                               scaled, q, c, a, c0 + c);
      else
        run_group<RMAX, INV, MM, LAZY, LANE, SWZ>(p, D, W, WP, tb, cs, mask, log2L, first,
                                                  last, scaled, q, c, a, c0 + c);
      off += 1 << (INV ? s0 + R : p.log2m - s0);
      s0 += R;
    }
  }
}

template <bool INV, int MM, bool LAZY, bool LANE, int RMAX, bool SWZ>
cudaError_t launch_reg(const RegArgs &p, int threads, int smem, cudaStream_t stream) {
  const long long work = ((p.B + (1ll << p.log2c) - 1) >> p.log2c) * p.A;
  return launch_resident(grouped_reg_kernel<INV, MM, LAZY, LANE, RMAX, SWZ>, p, threads, smem,
                         work, stream);
}

}  // namespace

// The register kernel.  log2c / log2q / smem: grouped_geometry's tile of
// 2^log2c batch entries, 2^log2q threads each, and its shared memory,
// which must equal this layout's: the tile of 2^(log2c + log2m) words, one more for each word of a fused twiddle
// (tw_mode 1 "pair": two, 2 "w": one), one table span a group (16 bytes
// an entry), each group's MAX_R x MAX_LOWS constant pairs and its mask
// word.
extern "C" int sventt_grouped_ntt(
    const void *x, void *out, const void *tab, const void *tabp, const void *cst,
    const void *cmask, const void *tw_w, const void *tw_wp, long long A, int log2m,
    long long B, long long sa, long long sm, long long sb, long long ta, long long tm,
    long long tb, int ngroups, unsigned long long ranks, int log2c, int log2q, int smem,
    int inverse, int modmul, int lazy, int lane, int tw_mode, unsigned long long N,
    unsigned long long ninv, void *stream) {
  if (ngroups < 1 || ngroups > MAX_GROUPS || log2m < 1 || log2m > 12)
    return (int)cudaErrorInvalidValue;
  int ntt_stages = 0, rmax = 0, tab_entries = 0;
  for (int g = 0; g < ngroups; ++g) {
    const int R = (int)((ranks >> (4 * g)) & 15);
    if (R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
    tab_entries += 1 << (inverse ? ntt_stages + R : log2m - ntt_stages);
    ntt_stages += R;
    rmax = R > rmax ? R : rmax;
  }
  if (ntt_stages != log2m || (ranks >> (4 * ngroups)) != 0) return (int)cudaErrorInvalidValue;
  if (A <= 0 || B <= 0 || log2c < 0 || log2q < 0 || log2c + log2q > 8 ||
      log2q > log2m - rmax || tw_mode < 0 || tw_mode > 2 ||
      (tw_mode != 0 && tw_w == nullptr) || ((tw_mode == 1) != (tw_wp != nullptr)) ||
      modmul < 0 || modmul > 1 || (modmul == 1 && !lazy))
    return (int)cudaErrorInvalidValue;
  const int tw_words = tw_mode == 0 ? 0 : (tw_mode == 1 ? 2 : 1);
  const long long tile_words = 1ll << (log2c + log2m);
  const long long want = tile_words * 8 * (1 + tw_words) + (long long)tab_entries * 16 +
                         (long long)ngroups * (CONSTS * 16 + 4);
  if (smem != want || want > MAX_SMEM) return (int)cudaErrorInvalidValue;
  RegArgs p;
  p.x = (const long long *)x;
  p.out = (long long *)out;
  p.tab = (const unsigned long long *)tab;
  p.tabp = (const unsigned long long *)tabp;
  p.cst = (const unsigned long long *)cst;
  p.cmask = (const unsigned char *)cmask;
  p.tw_w = (const long long *)tw_w;
  p.tw_wp = (const long long *)tw_wp;
  p.A = A;
  p.B = B;
  p.sa = sa;
  p.sm = sm;
  p.sb = sb;
  p.ta = ta;
  p.tm = tm;
  p.tb = tb;
  p.ranks = ranks;
  p.N = N;
  p.ninv = ninv;
  p.log2m = log2m;
  p.ngroups = ngroups;
  p.log2c = log2c;
  p.log2q = log2q;
  p.tw_mode = tw_mode;
  p.tw_words = tw_words;
  p.tile_words = (int)tile_words;
  p.tab_entries = tab_entries;
  const int threads = 1 << (log2c + log2q);
  cudaStream_t st = (cudaStream_t)stream;
  // the leaf's tile is swizzled below 16 columns, the lane's always
  const bool swz = log2c < 4;
#define SVENTT_LAUNCH_R(INV, MM, LAZY, LANE, SWZ)                                    \
  (rmax <= 3 ? launch_reg<INV, MM, LAZY, LANE, 3, SWZ>(p, threads, smem, st)         \
             : launch_reg<INV, MM, LAZY, LANE, 4, SWZ>(p, threads, smem, st))
#define SVENTT_LAUNCH(INV, MM, LAZY)                                                 \
  (lane ? SVENTT_LAUNCH_R(INV, MM, LAZY, true, true)                                 \
        : (swz ? SVENTT_LAUNCH_R(INV, MM, LAZY, false, true)                         \
               : SVENTT_LAUNCH_R(INV, MM, LAZY, false, false)))
  cudaError_t e;
  if (modmul == 1)  // Shoup is lazy only (FieldConsts.from_modulus)
    e = inverse ? SVENTT_LAUNCH(true, 1, true) : SVENTT_LAUNCH(false, 1, true);
  else if (lazy)
    e = inverse ? SVENTT_LAUNCH(true, 0, true) : SVENTT_LAUNCH(false, 0, true);
  else
    e = inverse ? SVENTT_LAUNCH(true, 0, false) : SVENTT_LAUNCH(false, 0, false);
#undef SVENTT_LAUNCH
#undef SVENTT_LAUNCH_R
  return (int)e;
}

// ---------------------------------------------------------------------------
// The rank-by-rank schedule (the A/B point): the tile in shared memory
// T[j * P + c], rows padded by one word, every group run there rank by
// rank with __syncthreads() between ranks, one thread per butterfly; the
// scalar constant of rank s, sub-slice low = (j0 mod h) / L, is cst[g][s]
// [low]; the combined table is read from device memory.
// ---------------------------------------------------------------------------

namespace {

constexpr int RANK_THREADS = 256;

template <bool INV, int MM, bool LAZY>
__global__ void __launch_bounds__(RANK_THREADS)
    grouped_ranks_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                   const unsigned long long *__restrict__ tab,
                   const unsigned long long *__restrict__ tabp,
                   const unsigned long long *__restrict__ cst,
                   const unsigned char *__restrict__ cmask,
                   const long long *__restrict__ tw_w,
                   const long long *__restrict__ tw_wp, long long A, int log2m,
                   long long B, long long sa, long long sm, long long sb, long long ta,
                   long long tm, long long tb, int ngroups, unsigned long long ranks,
                   int log2c, int lane, int tw_mode, u64 N, u64 ninv) {
  extern __shared__ __align__(16) unsigned char smem[];
  // T[j * P + c]: point j of tile column c, rows padded by one word
  u64 *T = reinterpret_cast<u64 *>(smem);
  const int m = 1 << log2m;
  const int cols = 1 << log2c;
  const int P = cols + 1;
  const int tile = m << log2c;
  const long long c0 = (long long)blockIdx.x << log2c;

  for (long long a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the previous slice is done with T
    for (int idx = threadIdx.x; idx < tile; idx += RANK_THREADS) {
      const int c = lane ? idx >> log2m : idx & (cols - 1);
      const int j = lane ? idx & (m - 1) : idx >> log2c;
      const long long col = c0 + c;
      u64 v = 0;
      if (col < B) {
        v = (u64)x[a * sa + j * sm + col * sb];
        if (tw_mode != 0 && !INV)
          v = inter_step_mul(v, tw_w, tw_wp, a * ta + j * tm + col * tb, tw_mode, N, ninv,
                             LAZY);
      }
      T[j * P + c] = v;
    }
    __syncthreads();

    int s0 = 0;  // stages of the groups before g
    for (int g = 0; g < ngroups; ++g) {
      const int R = (int)((ranks >> (4 * g)) & 15);
      const int log2L = INV ? s0 : log2m - s0 - R;
      // the combined table's span: 2l forward, 2^R * L inverse
      const int span_mask = (1 << (INV ? s0 + R : log2m - s0)) - 1;
      const bool scaled = INV && g == ngroups - 1;
      const unsigned long long *gt = tab + ((long long)g << log2m);
      const unsigned long long *gtp = tabp + ((long long)g << log2m);
      for (int s = 0; s < R; ++s) {
        const int log2h = INV ? log2L + s : log2L + R - 1 - s;
        const int h = 1 << log2h;
        const bool fused = INV ? s == 0 : s == R - 1;
        const int cbase = (g * MAX_R + s) * MAX_LOWS;
        for (int idx = threadIdx.x; idx < tile >> 1; idx += RANK_THREADS) {
          const int c = idx & (cols - 1);
          const int bi = idx >> log2c;  // butterfly index within the column
          const int jj = bi & (h - 1);
          const int j0 = ((bi - jj) << 1) + jj;
          u64 *p0 = T + j0 * P + c;
          u64 *p1 = p0 + h * P;
          u64 x0 = *p0;
          const u64 x1 = *p1;
          const int ci = cbase + (jj >> log2L);
          const bool has_c = __ldg(cmask + ci) != 0;
          // K7 leaves a first point with combined exponent 0 alone
          const bool first = lane || scaled || ((j0 & span_mask) >> log2L) != 0;
          if (!INV) {
            u64 y0 = add_mod(x0, x1, N, LAZY);
            u64 d;
            if (has_c) {
              d = (LAZY && !lane) ? x0 - x1 + 2 * N : sub_mod(x0, x1, N, LAZY);
              d = twiddle_mul<MM>(d, __ldg(cst + 2 * ci), __ldg(cst + 2 * ci + 1), N, LAZY);
            } else {
              d = sub_mod(x0, x1, N, LAZY);
            }
            if (fused) {
              if (first) y0 = twiddle_mul<MM>(y0, __ldg(gt + j0), __ldg(gtp + j0), N, LAZY);
              d = twiddle_mul<MM>(d, __ldg(gt + j0 + h), __ldg(gtp + j0 + h), N, LAZY);
            }
            *p0 = y0;
            *p1 = d;
          } else {
            u64 t = x1;
            if (fused) {
              if (first) x0 = twiddle_mul<MM>(x0, __ldg(gt + j0), __ldg(gtp + j0), N, LAZY);
              t = twiddle_mul<MM>(x1, __ldg(gt + j0 + h), __ldg(gtp + j0 + h), N, LAZY);
            } else if (has_c) {
              t = twiddle_mul<MM>(x1, __ldg(cst + 2 * ci), __ldg(cst + 2 * ci + 1), N, LAZY);
            }
            *p0 = add_mod(x0, t, N, LAZY);
            *p1 = sub_mod(x0, t, N, LAZY);
          }
        }
        __syncthreads();
      }
      s0 += R;
    }

    for (int idx = threadIdx.x; idx < tile; idx += RANK_THREADS) {
      const int c = lane ? idx >> log2m : idx & (cols - 1);
      const int j = lane ? idx & (m - 1) : idx >> log2c;
      const long long col = c0 + c;
      if (col < B) {
        u64 v = T[j * P + c];
        if (tw_mode != 0 && INV)
          v = inter_step_mul(v, tw_w, tw_wp, a * ta + j * tm + col * tb, tw_mode, N, ninv,
                             LAZY);
        out[a * sa + j * sm + col * sb] = (long long)v;
      }
    }
  }
}

template <bool INV, int MM, bool LAZY>
cudaError_t launch_ranks(dim3 grid, size_t smem, cudaStream_t stream, const long long *x,
                   long long *out, const unsigned long long *tab,
                   const unsigned long long *tabp, const unsigned long long *cst,
                   const unsigned char *cmask, const long long *tw_w,
                   const long long *tw_wp, long long A, int log2m, long long B,
                   long long sa, long long sm, long long sb, long long ta, long long tm,
                   long long tb, int ngroups, unsigned long long ranks, int log2c,
                   int lane, int tw_mode, u64 N, u64 ninv) {
  auto kern = grouped_ranks_kernel<INV, MM, LAZY>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, RANK_THREADS, smem, stream>>>(x, out, tab, tabp, cst, cmask, tw_w, tw_wp, A,
                                        log2m, B, sa, sm, sb, ta, tm, tb, ngroups, ranks,
                                        log2c, lane, tw_mode, N, ninv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sventt_grouped_ntt_ranks(
    const void *x, void *out, const void *tab, const void *tabp, const void *cst,
    const void *cmask, const void *tw_w, const void *tw_wp, long long A, int log2m,
    long long B, long long sa, long long sm, long long sb, long long ta, long long tm,
    long long tb, int ngroups, unsigned long long ranks, int log2c, int inverse,
    int modmul, int lazy, int lane, int tw_mode, unsigned long long N,
    unsigned long long ninv, void *stream) {
  int stages = 0;
  for (int g = 0; g < ngroups && g < 16; ++g) {
    const int R = (int)((ranks >> (4 * g)) & 15);
    if (R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
    stages += R;
  }
  if (A <= 0 || B <= 0 || log2m < 1 || log2m > 12 || log2c < 0 || log2c > 16 ||
      ngroups < 1 || ngroups > 12 || stages != log2m || tw_mode < 0 || tw_mode > 2 ||
      (tw_mode != 0 && tw_w == nullptr) || ((tw_mode == 1) != (tw_wp != nullptr)) ||
      modmul < 0 || modmul > 1 || (modmul == 1 && !lazy))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (((size_t)1 << log2c) + 1) * ((size_t)1 << log2m) * sizeof(u64);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const long long gy = A < 65535 ? A : 65535;
  const dim3 grid((unsigned)((B + (1ll << log2c) - 1) >> log2c), (unsigned)gy);
  cudaStream_t st = (cudaStream_t)stream;
  const auto *xp = (const long long *)x;
  auto *op = (long long *)out;
  const auto *tq = (const unsigned long long *)tab;
  const auto *tpq = (const unsigned long long *)tabp;
  const auto *cq = (const unsigned long long *)cst;
  const auto *mq = (const unsigned char *)cmask;
  const auto *wq = (const long long *)tw_w;
  const auto *wpq = (const long long *)tw_wp;
#define SVENTT_LAUNCH(INV, MM, LAZY)                                                   \
  launch_ranks<INV, MM, LAZY>(grid, smem, st, xp, op, tq, tpq, cq, mq, wq, wpq, A, log2m, B, \
                        sa, sm, sb, ta, tm, tb, ngroups, ranks, log2c, lane, tw_mode, N,  \
                        ninv)
  cudaError_t e;
  if (modmul == 1)  // Shoup is lazy only (FieldConsts.from_modulus)
    e = inverse ? SVENTT_LAUNCH(true, 1, true) : SVENTT_LAUNCH(false, 1, true);
  else if (lazy)
    e = inverse ? SVENTT_LAUNCH(true, 0, true) : SVENTT_LAUNCH(false, 0, true);
  else
    e = inverse ? SVENTT_LAUNCH(true, 0, false) : SVENTT_LAUNCH(false, 0, false);
#undef SVENTT_LAUNCH
  return (int)e;
}
