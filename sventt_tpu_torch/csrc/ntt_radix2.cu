// Radix-2 butterfly NTT for Hopper (sm_90a), the leaf and mid orientations,
// each column's stages in registers.
//
// Replaces the Pallas kernels of sventt_tpu/ops/ntt_pallas.py that the
// engine "pallas" runs with its default max_r = 1 across contiguous columns:
//   K4 :1154 _group_call (body _make_group_kernel :216): stages along axis 0
//      of (m, B) -- every column leaf;
//   K5 :1188 _mid_call: the same along axis 1 of (A, m, B) -- inner row
//      steps, the six-step inter-step twiddle fused (prologue forward,
//      epilogue inverse).
// K6 (_lane_call, points contiguous) stays on csrc/ntt_pallas.cu's
// butterfly_kernel, which also keeps this orientation's first port as the
// A/B point (ntt_pallas._launch_stages).  The plain PyTorch version is
// sventt_tpu_torch/ops/ntt_pallas.py::_stages_plain; the two agree bit for
// bit, lazy bits included: each butterfly is computed as butterfly_kernel
// computes it, only where its values live changes.
//
// What bounds it on the H100: 16 bytes a point (0.080 ms at 2^24; K5's
// (A, m) twiddle adds 16 bytes a row) against, per point and stage, half a
// stage multiply and the modular additions -- at m = 256 four Montgomery
// products a point, 0.093-0.097 ms at the product's measured 0.69-0.72 T/s
// on this card (tools/grouped_ablation.py), and 8 stages of 64-bit
// additions: instruction issue, not HBM, as for grouped_reg_kernel.  The
// first port (butterfly_kernel) spent about a third more on its schedule:
// a shared-memory round trip, index arithmetic and a barrier per stage.
//
// The design (radix2_reg_kernel), one launch per stage range [first, last):
// * The range splits into groups of up to 4 consecutive stages
//   (ntt_pallas.py::butterfly_geometry; 4 + 4 at m = 256).  Group g of R
//   stages, row unit L (forward L = m >> (s0 + R), inverse L = 2^s0, s0 the
//   stages before it) couples the 2^R points base + k L of a column (set
//   walk: reg_tile.cuh set_base); one thread holds them (v[], R a template
//   parameter) and runs the group's R stages with no barrier.  Forward rank
//   s pairs k and k + h, h = 2^(R-1-s) points apart; inverse rank s pairs k
//   and k + 2^s.  The pair's stage twiddle, of half-width l = h L, is
//   w[l - 1 + (j mod l)] with j mod l = lo + (k mod h) L: table index
//   (h + k mod h) L + lo - 1, an entry a set computes from its lo once.
// * One exchange per group boundary.  The first group reads its points
//   straight from device memory and the last writes them straight back, a
//   warp's lanes on neighbouring columns (thread u: set u >> log2 C, column
//   u mod C), so every access is a coalesced row of columns.  Between
//   groups the sets meet in the tile, point j of column c at slot(j C + c)
//   (swizzled below 16 columns, as grouped_reg_kernel's leaf), a barrier
//   between groups.  At m = 256 that is 1 tile pass where butterfly_kernel
//   made 10 (a copy in, 8 stages, a copy out).
// * Warp-uniform tables.  All lanes of a warp hold the same sets of
//   neighbouring columns (C >= 32), so a stage twiddle is one value for the
//   warp: the range's slice of the (m-1,) tables is staged once per resident
//   block as 16-byte (w, wp) pairs (8-byte w under Solinas) and read by a
//   broadcast.  K5's inter-step twiddle tw[a, j] is broadcast over the
//   columns: each tile stages slice a's row of m entries the same way (no
//   tile of the data's size), so the inverse's epilogue does not wait on
//   device-memory reads just before its stores (read through __ldg there,
//   it left K5's inverse slower than butterfly_kernel's).
// * Geometry: butterfly_geometry picks C columns a tile (block_b when set;
//   else 32, halved while the tile exceeds a third of an SM's shared memory
//   or the grid has fewer than two blocks an SM, down to 4) and its threads,
//   C times the widest group's set count, at most 256; resident blocks walk
//   the (slice, tile) work, so A > 65535 slices need no second grid axis.
//   The C entry recomputes the layout and refuses any other.
// Per butterfly, as butterfly_kernel and the plain version:
//   forward  (x0 + x1, (x0 - x1 [+2N unreduced when lazy]) * w)
//   inverse  t = x1 * w: (x0 + t, x0 - t); the last stage (1/m folded)
//            a = x0 * s, b = x1 * sw: (a + b, a - b)
// Stage multiplies are Montgomery, Shoup or Solinas (template MM 0 / 1 / 2);
// the fused inter-step twiddle is Montgomery (tw_mode 1 "pair", 2 "w") or,
// in the Solinas instantiations, Solinas (3).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "reg_tile.cuh"

namespace {

constexpr int R2_MAX_R = 4;      // stages a group may have
constexpr int R2_THREADS = 256;  // the largest block
constexpr int R2_MAX_GROUPS = 12;

struct R2Args {
  const long long *x;
  long long *out;
  const unsigned long long *w, *wp;  // the compact (m-1,) stage tables
  const long long *tw_w, *tw_wp;     // the (A, m) inter-step twiddle
  long long A, B, sa, sm, sb, ta, tm;
  unsigned long long ranks;  // each group's stages, 4 bits a group, in run order
  u64 N, ninv, s, sp;
  int log2m, first, last, ngroups, log2c, tw_mode, tile_words, tab_lo, tab_entries;
  bool fused;  // the range multiplies the inter-step twiddle (prologue or epilogue)
};

// Stage-table entry i of the staged slice: (w, wp), or w alone (Solinas).
template <int MM>
__device__ __forceinline__ void tab_entry(const void *TB, int i, u64 &w, u64 &wp) {
  if constexpr (MM == 2) {
    w = reinterpret_cast<const u64 *>(TB)[i];
    wp = 0;
  } else {
    const ulonglong2 e = reinterpret_cast<const ulonglong2 *>(TB)[i];
    w = e.x;
    wp = e.y;
  }
}

// The fused inter-step multiply of v (point j of the slice) by the staged
// twiddle row TW: Solinas (tw_mode 3) in the Solinas instantiations,
// Montgomery with the companion ("pair", 1: 16-byte entries) or computing
// it ("w", 2) in the others, as field.cuh inter_step_mul (the C entry pairs
// the modes so).
template <int MM, bool LAZY>
__device__ __forceinline__ u64 tw_mul(const R2Args &p, const void *TW, u64 v, int j) {
  if constexpr (MM == 2) {
    return solinas_mul(v, reinterpret_cast<const u64 *>(TW)[j], p.N);
  } else if (p.tw_mode == 1) {
    const ulonglong2 e = reinterpret_cast<const ulonglong2 *>(TW)[j];
    return mont_mul(v, e.x, e.y, p.N, LAZY);
  } else {
    return mont_mul_full(v, reinterpret_cast<const u64 *>(TW)[j], p.N, p.ninv, LAZY);
  }
}

// Group of R stages (row unit 2^log2L) on every (set, column) unit this
// thread owns in the tile of slice a, columns c0 ...: read the set (from
// device memory in the first group, `from_mem`, the forward twiddle then),
// run its stages, write it back to the tile or, in the last group
// (`to_mem`; the inverse twiddle first), to device memory.
template <int R, bool INV, int MM, bool LAZY, bool SWZ>
__device__ __forceinline__ void run_stages(const R2Args &p, u64 *T, const void *TB,
                                           const void *TW, int log2L, bool from_mem,
                                           bool to_mem, long long a, long long c0) {
  constexpr int K = 1 << R;
  const u64 N = p.N;
  const int L = 1 << log2L;
  const int units = 1 << (p.log2m - R + p.log2c);
  const bool prologue = !INV && from_mem && p.fused;
  const bool epilogue = INV && to_mem && p.fused;
  // the last stage of the transform, in this group's last rank
  const bool scaled = INV && to_mem && p.last == p.log2m;
  const long long Lsm = (long long)L * p.sm;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int set = u >> p.log2c;
    const int c = u & ((1 << p.log2c) - 1);
    const int base = set_base(set, log2L, R);
    const int tb = (set & (L - 1)) - 1 - p.tab_lo;  // + (h + k mod h) L: the table entry
    const long long col = c0 + c;
    const bool ok = col < p.B;
#define SVENTT_SLOT(k) slot<SWZ>(((base + (k) * L) << p.log2c) + c)
    u64 v[K];
    if (from_mem) {
      const long long *src = p.x + (ok ? a * p.sa + col * p.sb + base * p.sm : 0);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = ok ? (u64)src[k * Lsm] : 0ull;
      if (prologue) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = tw_mul<MM, LAZY>(p, TW, v[k], base + k * L);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = T[SVENTT_SLOT(k)];
    }

#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int h = INV ? 1 << s : 1 << (R - 1 - s);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k & h) continue;
        u64 w, wp;
        tab_entry<MM>(TB, ((h + (k & (h - 1))) << log2L) + tb, w, wp);
        const u64 x0 = v[k], x1 = v[k + h];
        if (!INV) {
          v[k] = add_mod(x0, x1, N, LAZY);
          const u64 d = LAZY ? x0 - x1 + 2 * N : sub_mod(x0, x1, N, LAZY);
          v[k + h] = twiddle_mul<MM>(d, w, wp, N, LAZY);
        } else if (scaled && s == R - 1) {
          const u64 a0 = twiddle_mul<MM>(x0, p.s, p.sp, N, LAZY);
          const u64 b1 = twiddle_mul<MM>(x1, w, wp, N, LAZY);
          v[k] = add_mod(a0, b1, N, LAZY);
          v[k + h] = sub_mod(a0, b1, N, LAZY);
        } else {
          const u64 t = twiddle_mul<MM>(x1, w, wp, N, LAZY);
          v[k] = add_mod(x0, t, N, LAZY);
          v[k + h] = sub_mod(x0, t, N, LAZY);
        }
      }
    }

    if (to_mem) {
      if (epilogue) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = tw_mul<MM, LAZY>(p, TW, v[k], base + k * L);
      }
      if (ok) {
        long long *dst = p.out + a * p.sa + col * p.sb + base * p.sm;
#pragma unroll
        for (int k = 0; k < K; ++k) dst[k * Lsm] = (long long)v[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) T[SVENTT_SLOT(k)] = v[k];
    }
#undef SVENTT_SLOT
  }
}

// Blocks of 256 threads an SM whose registers the compiler must fit: three
// where a thread holds at most 8 points, two at 16.
template <int RMAX>
constexpr int r2_blocks() {
  return RMAX <= 3 ? 3 : 2;
}

// RMAX: the most stages a group of the call has (3 or 4: 8 or 16 points a
// thread).  SWZ: the tile is swizzled (below 16 columns a tile).
template <bool INV, int MM, bool LAZY, int RMAX, bool SWZ>
__global__ void __launch_bounds__(R2_THREADS, r2_blocks<RMAX>())
    radix2_reg_kernel(const R2Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64 *T = reinterpret_cast<u64 *>(smem);  // the exchange tile (none for one group)
  void *TB = T + p.tile_words;             // the range's stage-table slice
  // the slice's inter-step twiddle row (where the range multiplies it)
  void *TW = reinterpret_cast<unsigned char *>(TB) + p.tab_entries * (MM == 2 ? 8 : 16);
  for (int e = threadIdx.x; e < p.tab_entries; e += blockDim.x) {
    const int i = p.tab_lo + e;
    if constexpr (MM == 2)
      reinterpret_cast<u64 *>(TB)[e] = __ldg(p.w + i);
    else
      reinterpret_cast<ulonglong2 *>(TB)[e] = make_ulonglong2(__ldg(p.w + i), __ldg(p.wp + i));
  }
  __syncthreads();

  const long long tiles = (p.B + (1ll << p.log2c) - 1) >> p.log2c;
  const long long work = tiles * p.A;
  for (long long wk = blockIdx.x; wk < work; wk += gridDim.x) {
    const long long a = wk / tiles;
    const long long c0 = (wk - a * tiles) << p.log2c;
    if (p.ngroups > 1 || p.fused) __syncthreads();  // the previous tile is done with T, TW
    if (p.fused) {  // slice a's twiddle row, read by a broadcast (warp-uniform j)
      for (int j = threadIdx.x; j < 1 << p.log2m; j += blockDim.x) {
        const long long i = a * p.ta + j * p.tm;
        if (MM != 2 && p.tw_mode == 1)
          reinterpret_cast<ulonglong2 *>(TW)[j] =
              make_ulonglong2((u64)__ldg(p.tw_w + i), (u64)__ldg(p.tw_wp + i));
        else
          reinterpret_cast<u64 *>(TW)[j] = (u64)__ldg(p.tw_w + i);
      }
      __syncthreads();
    }
    for (int g = 0, s0 = p.first; g < p.ngroups; ++g) {
      const int R = (int)((p.ranks >> (4 * g)) & 15);
      const int log2L = INV ? s0 : p.log2m - s0 - R;
      const bool from_mem = g == 0, to_mem = g == p.ngroups - 1;
      if (!from_mem) __syncthreads();  // the previous group's sets are in the tile
      if (R == 1)
        run_stages<1, INV, MM, LAZY, SWZ>(p, T, TB, TW, log2L, from_mem, to_mem, a, c0);
      else if (R == 2)
        run_stages<2, INV, MM, LAZY, SWZ>(p, T, TB, TW, log2L, from_mem, to_mem, a, c0);
      else if (RMAX < 4 || R == 3)
        run_stages<3, INV, MM, LAZY, SWZ>(p, T, TB, TW, log2L, from_mem, to_mem, a, c0);
      else
        run_stages<RMAX, INV, MM, LAZY, SWZ>(p, T, TB, TW, log2L, from_mem, to_mem, a, c0);
      s0 += R;
    }
  }
}

template <bool INV, int MM, bool LAZY, int RMAX, bool SWZ>
cudaError_t launch_r2(const R2Args &p, int threads, int smem, cudaStream_t stream) {
  const long long work = ((p.B + (1ll << p.log2c) - 1) >> p.log2c) * p.A;
  return launch_resident(radix2_reg_kernel<INV, MM, LAZY, RMAX, SWZ>, p, threads, smem, work,
                         stream);
}

}  // namespace

// The register kernel on stages [first, last) of the compact tables w / wp
// along axis 1 of the (A, m, B) view (element strides sa, sm, sb), the
// inter-step twiddle (tw_mode 1 "pair", 2 "w", 3 Solinas) at tw_w[a ta +
// j tm], broadcast over the columns.  ranks / log2c / threads / smem:
// butterfly_geometry's groups (4 bits each), tile of 2^log2c columns, block
// and shared memory, which must equal this layout's: the exchange tile of
// 2^(log2c + log2m) words where there are two groups or more, the range's
// slice of the stage tables, entries [lmin - 1, 2 lmax - 1) of the
// half-widths it runs, 16 bytes an entry (8 under Solinas), and, where the
// range multiplies the twiddle (forward from stage 0, inverse to the last),
// a row of m twiddles, 16 bytes an entry "pair" and 8 otherwise.
extern "C" int sventt_radix2_ntt(
    const void *x, void *out, const void *w, const void *wp, const void *tw_w,
    const void *tw_wp, long long A, int log2m, long long B, long long sa, long long sm,
    long long sb, long long ta, long long tm, int first, int last, unsigned long long ranks,
    int log2c, int threads, int smem, int inverse, int modmul, int lazy, int tw_mode,
    unsigned long long N, unsigned long long ninv, unsigned long long s,
    unsigned long long sp, void *stream) {
  if (A <= 0 || B <= 0 || log2m < 1 || log2m > 12 || first < 0 || first >= last ||
      last > log2m || log2c < 0 || log2c > 12 || tw_mode < 0 || tw_mode > 3 ||
      (tw_mode != 0 && tw_w == nullptr) || ((tw_mode == 1) != (tw_wp != nullptr)) ||
      modmul < 0 || modmul > 2 || (modmul == 1 && !lazy) ||
      // Solinas: canonical, companion-free stages, its own inter-step mode;
      // and only Solinas takes that mode
      (modmul == 2 && (lazy || wp != nullptr || (tw_mode != 0 && tw_mode != 3))) ||
      (modmul != 2 && (wp == nullptr || tw_mode == 3)))
    return (int)cudaErrorInvalidValue;
  int ngroups = 0, stages = 0, rmax = 0;
  for (; ngroups < R2_MAX_GROUPS && ((ranks >> (4 * ngroups)) & 15) != 0; ++ngroups) {
    const int R = (int)((ranks >> (4 * ngroups)) & 15);
    if (R > R2_MAX_R) return (int)cudaErrorInvalidValue;
    stages += R;
    rmax = R > rmax ? R : rmax;
  }
  if (ngroups == 0 || stages != last - first || (ranks >> (4 * ngroups)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long units = 1ll << (log2m - rmax + log2c);  // the widest group's
  if (threads != (units < R2_THREADS ? units : R2_THREADS)) return (int)cudaErrorInvalidValue;
  const int lmin = inverse ? 1 << first : 1 << (log2m - last);
  const int lmax = inverse ? 1 << (last - 1) : 1 << (log2m - first - 1);
  const long long tile_words = ngroups > 1 ? 1ll << (log2c + log2m) : 0;
  const int tab_entries = 2 * lmax - lmin;
  const bool fused = tw_mode != 0 && (inverse ? last == log2m : first == 0);
  const long long want = 8 * tile_words + (long long)tab_entries * (modmul == 2 ? 8 : 16) +
                         (fused ? (8ll << log2m) * (tw_mode == 1 ? 2 : 1) : 0);
  if (smem != want || want > MAX_SMEM) return (int)cudaErrorInvalidValue;
  R2Args p;
  p.x = (const long long *)x;
  p.out = (long long *)out;
  p.w = (const unsigned long long *)w;
  p.wp = (const unsigned long long *)wp;
  p.tw_w = (const long long *)tw_w;
  p.tw_wp = (const long long *)tw_wp;
  p.A = A;
  p.B = B;
  p.sa = sa;
  p.sm = sm;
  p.sb = sb;
  p.ta = ta;
  p.tm = tm;
  p.ranks = ranks;
  p.N = N;
  p.ninv = ninv;
  p.s = s;
  p.sp = sp;
  p.log2m = log2m;
  p.first = first;
  p.last = last;
  p.ngroups = ngroups;
  p.log2c = log2c;
  p.tw_mode = tw_mode;
  p.tile_words = (int)tile_words;
  p.tab_lo = lmin - 1;
  p.tab_entries = tab_entries;
  p.fused = fused;
  cudaStream_t st = (cudaStream_t)stream;
  const bool swz = log2c < 4;  // a half-warp spans several points below 16 columns
#define SVENTT_LAUNCH_R(INV, MM, LAZY)                                                  \
  (rmax <= 3 ? (swz ? launch_r2<INV, MM, LAZY, 3, true>(p, threads, smem, st)           \
                    : launch_r2<INV, MM, LAZY, 3, false>(p, threads, smem, st))         \
             : (swz ? launch_r2<INV, MM, LAZY, 4, true>(p, threads, smem, st)           \
                    : launch_r2<INV, MM, LAZY, 4, false>(p, threads, smem, st)))
  cudaError_t e;
  if (modmul == 2)  // Solinas is canonical only (64-bit moduli)
    e = inverse ? SVENTT_LAUNCH_R(true, 2, false) : SVENTT_LAUNCH_R(false, 2, false);
  else if (modmul == 1)  // Shoup is lazy only (FieldConsts.from_modulus)
    e = inverse ? SVENTT_LAUNCH_R(true, 1, true) : SVENTT_LAUNCH_R(false, 1, true);
  else if (lazy)
    e = inverse ? SVENTT_LAUNCH_R(true, 0, true) : SVENTT_LAUNCH_R(false, 0, true);
  else
    e = inverse ? SVENTT_LAUNCH_R(true, 0, false) : SVENTT_LAUNCH_R(false, 0, false);
#undef SVENTT_LAUNCH_R
  return (int)e;
}
