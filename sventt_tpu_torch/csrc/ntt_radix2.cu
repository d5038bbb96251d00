// Radix-2 butterfly NTT for Hopper (sm_90a): one register kernel, three
// orientations, each set of a stage group's points in registers.
//
// Replaces the Pallas kernels of sventt_tpu/ops/ntt_pallas.py that the
// engine "pallas" runs with its default max_r = 1:
//   K4 :1154 _group_call (body _make_group_kernel :216): stages along axis 0
//      of (m, B) -- every column leaf;
//   K5 :1188 _mid_call: the same along axis 1 of (A, m, B) -- inner row
//      steps, the six-step inter-step twiddle fused (prologue forward,
//      epilogue inverse);
//   K6 :911 _lane_call (body _lane_kernel :819): every stage along the last
//      axis of (rows, m) -- the unbatched root row step, the inter-step
//      twiddle of the data's layout fused the same way.
// The plain PyTorch version is
// sventt_tpu_torch/ops/ntt_pallas.py::_stages_plain; the two agree bit for
// bit, lazy bits included: each butterfly is computed as the plain version
// computes it (below), only where its values live differs.
//
// What bounds it on the H100: 16 bytes a point (0.080 ms at 2^24; K5's
// (A, m) twiddle adds 16 bytes a row, K6's twiddle of the data's size 16 a
// point: 0.160 ms) against, per point and stage, half a stage multiply and
// the modular additions -- at m = 256 four Montgomery products a point
// (five with K6's twiddle), 0.093-0.097 ms at the product's measured
// 0.69-0.72 T/s on this card (tools/grouped_ablation.py), and 8 stages of
// 64-bit additions: instruction issue for K4 / K5, as for
// grouped_reg_kernel; K6 adds the twiddle's bytes, which the issue time
// does not fully hide (PERF.md).  A schedule with a shared-memory round
// trip, index arithmetic and a barrier per stage spends more: PERF.md has
// its times.
//
// The design (radix2_reg_kernel), one launch per stage range [first, last):
// * The range splits into groups of up to 4 consecutive stages
//   (ntt_pallas.py::butterfly_geometry; 4 + 4 at m = 256).  Group g of R
//   stages, row unit L (forward L = m >> (s0 + R), inverse L = 2^s0, s0 the
//   stages before it) couples the 2^R points base + k L of a transform (set
//   walk: reg_tile.cuh set_base); one thread holds them (v[], R a template
//   parameter) and runs the group's R stages with no barrier.  Forward rank
//   s pairs k and k + h, h = 2^(R-1-s) points apart; inverse rank s pairs k
//   and k + 2^s.  The pair's stage twiddle, of half-width l = h L, is
//   w[l - 1 + (j mod l)] with j mod l = lo + (k mod h) L: table index
//   (h + k mod h) L + lo - 1, an entry a set computes from its lo once.
// * One exchange per group boundary, through a shared-memory tile, a
//   barrier between groups; the first group reads its points straight
//   from device memory and the last writes them straight back.
// * Leaf / mid (K4, K5): a warp's lanes on neighbouring columns (thread u:
//   set u >> log2 C, column u mod C), so every access is a coalesced row of
//   columns; point j of column c sits at slot(j C + c) (swizzled below 16
//   columns, as grouped_reg_kernel's leaf).  At m = 256 that is 1 tile pass,
//   against 10 for a tile run stage by stage (a copy in, 8 stages, a copy
//   out).
//   All lanes of a warp hold the same sets of neighbouring columns (C >=
//   32), so a stage twiddle is one value for the warp: the range's slice of
//   the (m-1,) tables is staged once per resident block as 16-byte (w, wp)
//   pairs (8-byte w under Solinas) and read by a broadcast.  K5's
//   inter-step twiddle tw[a, j] is broadcast over the columns: each tile
//   stages slice a's row of m entries the same way, so the inverse's
//   epilogue does not wait on device-memory reads just before its stores.
// * Lane (K6): a warp's lanes on neighbouring sets of a row (unit u: row
//   u >> log2(m >> R), set u mod (m >> R)); point j of row r sits at
//   slot(r m + j), always swizzled (a half-warp spans several lines).  The
//   forward's first group and the inverse's last have L = m >> R: lane i
//   holds points lo + k L with lo = i, so every read of x and every store
//   of out is a coalesced run of a row.  The other end of the row (L = 1,
//   the forward's last group and the inverse's first), where a set is 2^R
//   neighbouring words and the lanes stride 2^R words, goes through the
//   tile: the inverse copies the tile in with cp.async first, the forward
//   copies it out after its last group, both word by word along the rows.
//   The fused twiddle has the data's layout (one entry a point, used once).
//   The forward reads it straight into registers with its x, coalesced the
//   same way, and multiplies it there.  The inverse, which multiplies it
//   just before its stores, stages it a tile at a time in shared memory by
//   cp.async, at the tile's slots, while its first groups run: read
//   straight from device memory there it left K6's inverse slower than a
//   stage-by-stage schedule (the stores waited on the reads, as K5's had),
//   and staged in
//   the forward too it was slower (tools/grouped_ablation.py "twiddle
//   direct" times the unstaged form).  Each tile of C
//   rows is one contiguous run of C m words, addressed from one 64-bit
//   offset; every other index is 32-bit.  The stage-table entry differs
//   across the lanes where L > 1 (neighbouring lanes read neighbouring
//   16-byte entries) and is warp-uniform where L = 1.  At m = 256 (4 + 4)
//   that is 2 tile passes (the exchange and the end), against 10 stage by
//   stage.  tools/grouped_ablation.py times the other ends: each
//   thread's 2^R words straight from / to device memory, as 8-byte or
//   16-byte accesses.  A 1-D bulk copy (TMA) of the tile cannot swizzle it,
//   and the L = 1 group's accesses to an unswizzled tile are 16-way bank
//   conflicts at R = 4: not built.
// * Geometry: butterfly_geometry picks the C batch entries a tile -- leaf /
//   mid: block_b columns when set, else 32; lane: the lane_rows knob when
//   set, else as many rows as fill 128 threads (four blocks an SM, as the
//   registers allow, ran faster than two of 256) -- halved while the tile
//   exceeds a third of an SM's shared memory or the grid has fewer than two
//   blocks an SM (leaf down to 4 columns, lane to 1 row), and the threads,
//   C times the widest group's set count, at most 256; resident blocks walk
//   the (slice, tile) work, so A > 65535 slices need no second grid axis.
//   The C entry recomputes the layout and refuses any other.
// Per butterfly, as the plain version:
//   forward  K4/K5: (x0 + x1, (x0 - x1 [+2N unreduced when lazy]) * w)
//            K6:    (x0 + x1, sub(x0, x1) * w)
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
  const long long *tw_w, *tw_wp;     // the inter-step twiddle
  long long A, B, sa, sm, sb, ta, tm;
  unsigned long long ranks;  // each group's stages, 4 bits a group, in run order
  u64 N, ninv, s, sp;
  int log2m, first, last, ngroups, log2c, tw_mode, tile_words, tab_lo, tab_entries;
  bool fused;   // the range multiplies the inter-step twiddle (prologue or epilogue)
  bool staged;  // the lane inverse stages it in shared memory (lane_tiles)
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

// The same multiply of v[k] by the lane twiddle of word w0 + k L of the
// tile: from the staging buffers SW / SWP (slot() of the word) where they
// are given (the inverse only: STAGED), else straight from device memory
// (W / WP: the tile's first row of it).  The forward's reads carry no
// runtime choice of source: with one, the forward ran slower in a
// same-call comparison than with its reads fixed at compile time.
template <int K, int MM, bool LAZY, bool STAGED>
__device__ __forceinline__ void lane_twiddle(const R2Args &p, u64 (&v)[K], const long long *W,
                                             const long long *WP, const u64 *SW, const u64 *SWP,
                                             int w0, int L) {
  const bool pair = MM != 2 && p.tw_mode == 1;
  const bool staged = STAGED && SW != nullptr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = w0 + k * L;
    const u64 w = staged ? SW[slot<true>(i)] : (u64)W[i];
    if constexpr (MM == 2)
      v[k] = solinas_mul(v[k], w, p.N);
    else if (pair)
      v[k] = mont_mul(v[k], w, staged ? SWP[slot<true>(i)] : (u64)WP[i], p.N, LAZY);
    else
      v[k] = mont_mul_full(v[k], w, p.N, p.ninv, LAZY);
  }
}

// The R stages of a group on the 2^R points v of one set (its table entries
// at ((h + k mod h) << log2L) + tb); `scaled`: the group's last rank is the
// transform's last inverse stage (1/m folded).  LANE: K6's forward
// difference, reduced; K4 / K5 bias a lazy one by +2N.
template <int R, bool INV, int MM, bool LAZY, bool LANE>
__device__ __forceinline__ void butterflies(const R2Args &p, u64 (&v)[1 << R], const void *TB,
                                            int tb, int log2L, bool scaled) {
  const u64 N = p.N;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int h = INV ? 1 << s : 1 << (R - 1 - s);
#pragma unroll
    for (int k = 0; k < 1 << R; ++k) {
      if (k & h) continue;
      u64 w, wp;
      tab_entry<MM>(TB, ((h + (k & (h - 1))) << log2L) + tb, w, wp);
      const u64 x0 = v[k], x1 = v[k + h];
      if (!INV) {
        v[k] = add_mod(x0, x1, N, LAZY);
        const u64 d = LAZY && !LANE ? x0 - x1 + 2 * N : sub_mod(x0, x1, N, LAZY);
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
}

// Leaf / mid: group of R stages (row unit 2^log2L) on every (set, column)
// unit this thread owns in the tile of slice a, columns c0 ...: read the
// set (from device memory in the first group, `from_mem`, the forward
// twiddle then), run its stages, write it back to the tile or, in the last
// group (`to_mem`; the inverse twiddle first), to device memory.
template <int R, bool INV, int MM, bool LAZY, bool SWZ>
__device__ __forceinline__ void run_stages(const R2Args &p, u64 *T, const void *TB,
                                           const void *TW, int log2L, bool from_mem,
                                           bool to_mem, long long a, long long c0) {
  constexpr int K = 1 << R;
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
    butterflies<R, INV, MM, LAZY, false>(p, v, TB, tb, log2L, scaled);
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

// Lane: group of R stages (row unit 2^log2L) on every (row, set) unit this
// thread owns in a tile of `rows` valid rows (X, O, TWW, TWP: the tile's
// first row of x, out and the twiddle; SW, SWP: the tile's staged twiddle,
// or null; word w of the tile is point w mod m of row w >> log2m).
// `in_mem`: read the set from device memory (the forward twiddle then),
// else from the tile; `out_mem`: write it to device memory (the inverse
// twiddle first), else to the tile.
template <int R, bool INV, int MM, bool LAZY>
__device__ __forceinline__ void lane_stages(const R2Args &p, u64 *T, const void *TB,
                                            const long long *X, long long *O,
                                            const long long *TWW, const long long *TWP,
                                            const u64 *SW, const u64 *SWP, int rows, int log2L,
                                            bool in_mem, bool out_mem, bool scaled) {
  constexpr int K = 1 << R;
  const int L = 1 << log2L;
  const int log2s = p.log2m - R;  // sets a row
  const int units = 1 << (log2s + p.log2c);
  const bool prologue = !INV && in_mem && p.fused;
  const bool epilogue = INV && out_mem && p.fused;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int row = u >> log2s;
    const int set = u & ((1 << log2s) - 1);
    const int tb = (set & (L - 1)) - 1 - p.tab_lo;
    const int w0 = (row << p.log2m) + set_base(set, log2L, R);  // the set's first word
    const bool ok = row < rows;
    u64 v[K];
    if (in_mem) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = ok ? (u64)X[w0 + k * L] : 0ull;
      if (prologue && ok) lane_twiddle<K, MM, LAZY, INV>(p, v, TWW, TWP, SW, SWP, w0, L);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = T[slot<true>(w0 + k * L)];
    }
    butterflies<R, INV, MM, LAZY, true>(p, v, TB, tb, log2L, scaled);
    if (out_mem) {
      if (ok) {
        if (epilogue) lane_twiddle<K, MM, LAZY, INV>(p, v, TWW, TWP, SW, SWP, w0, L);
#pragma unroll
        for (int k = 0; k < K; ++k) O[w0 + k * L] = (long long)v[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) T[slot<true>(w0 + k * L)] = v[k];
    }
  }
}

// The lane twiddle of tile wk (C m words from word wk C m on, zeros past
// the rows) into the staging buffers SW / SWP at the tile's slots, by
// cp.async, committed as one group.
__device__ __forceinline__ void stage_twiddle(const R2Args &p, u64 *SW, u64 *SWP, long long wk) {
  const long long off = wk << (p.log2c + p.log2m);
  const long long left = (p.B << p.log2m) - off;
  const int words = left < p.tile_words ? (int)left : p.tile_words;
  for (int i = threadIdx.x; i < p.tile_words; i += blockDim.x) {
    const long long at = off + (i < words ? i : 0);
    cp_async8(SW + slot<true>(i), p.tw_w + at, i < words);
    if (SWP != nullptr) cp_async8(SWP + slot<true>(i), p.tw_wp + at, i < words);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Every lane tile of the launch, each through its groups.  The group of row
// unit 1 at either end of a multi-group row (see the file's header) runs on
// the tile, copied in before it (inverse) or out after it (forward).  Where
// a tile's worth of the inverse's twiddle fits beside the tile (p.staged),
// it is staged in shared memory (SW: the buffer) by cp.async behind the
// tile's copy-in, for the last group.
template <bool INV, int MM, bool LAZY, int RMAX>
__device__ __forceinline__ void lane_tiles(const R2Args &p, u64 *T, const void *TB, u64 *SW) {
  const long long tiles = (p.B + (1ll << p.log2c) - 1) >> p.log2c;
  const int last = p.ngroups - 1;
  const bool staged = INV && p.staged;  // (the C entry stages the inverse's only)
  if (!staged) SW = nullptr;
  u64 *SWP = staged && p.tw_wp != nullptr ? SW + p.tile_words : nullptr;
  for (long long wk = blockIdx.x; wk < tiles; wk += gridDim.x) {
    const long long r0 = wk << p.log2c;
    const long long off = r0 << p.log2m;  // the tile's first word
    const long long left = p.B - r0;
    const int rows = left < (1ll << p.log2c) ? (int)left : 1 << p.log2c;
    const int words = rows << p.log2m;
    const long long *X = p.x + off;
    long long *O = p.out + off;
    const long long *TWW = p.fused ? p.tw_w + off : nullptr;
    const long long *TWP = p.fused && p.tw_wp != nullptr ? p.tw_wp + off : nullptr;
    if (p.ngroups > 1) __syncthreads();  // the previous tile is done with T and SW
    for (int g = 0, s0 = p.first; g < p.ngroups; ++g) {
      const int R = (int)((p.ranks >> (4 * g)) & 15);
      const int log2L = INV ? s0 : p.log2m - s0 - R;
      const bool end = p.ngroups > 1 && log2L == 0;  // the row's contiguous end
      if (g == 0 && end) {  // the inverse's first group: the tile in
        for (int i = threadIdx.x; i < p.tile_words; i += blockDim.x)
          cp_async8(T + slot<true>(i), X + (i < words ? i : 0), i < words);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      // the inverse's twiddle, for its last group: lands while the first run
      if (g == 0 && staged) stage_twiddle(p, SW, SWP, wk);
      if (g == 0 && end) {  // the tile, not the twiddle
        if (staged)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
      }
      if (staged && g == last) cp_async_wait<0>();
      if (g > 0 || end) __syncthreads();  // the tile holds the previous group's sets
      const bool in_mem = g == 0 && !end, out_mem = g == last && !end;
      const bool scaled = INV && g == last && p.last == p.log2m;
#define SVENTT_LANE(RR)                                                                      \
  lane_stages<RR, INV, MM, LAZY>(p, T, TB, X, O, TWW, TWP, SW, SWP, rows, log2L, in_mem, \
                                 out_mem, scaled)
      if (R == 1)
        SVENTT_LANE(1);
      else if (R == 2)
        SVENTT_LANE(2);
      else if (RMAX < 4 || R == 3)
        SVENTT_LANE(3);
      else
        SVENTT_LANE(RMAX);
#undef SVENTT_LANE
      if (g == last && end) {
        __syncthreads();
        for (int i = threadIdx.x; i < words; i += blockDim.x) O[i] = (long long)T[slot<true>(i)];
      }
      s0 += R;
    }
  }
}

// Every leaf / mid (slice, tile) work item of the launch, each through its
// groups (TW: the slice's staged twiddle row).
template <bool INV, int MM, bool LAZY, int RMAX, bool SWZ>
__device__ __forceinline__ void leaf_tiles(const R2Args &p, u64 *T, const void *TB, void *TW) {
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

// Blocks of 256 threads an SM whose registers the compiler must fit: three
// where a thread holds at most 8 points, two at 16.
template <int RMAX>
constexpr int r2_blocks() {
  return RMAX <= 3 ? 3 : 2;
}

// RMAX: the most stages a group of the call has (3 or 4: 8 or 16 points a
// thread).  SWZ: the leaf / mid tile is swizzled (below 16 columns a tile;
// the lane's always is).  LANE: the lane orientation (K6).
template <bool INV, int MM, bool LAZY, int RMAX, bool SWZ, bool LANE>
__global__ void __launch_bounds__(R2_THREADS, r2_blocks<RMAX>())
    radix2_reg_kernel(const R2Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64 *T = reinterpret_cast<u64 *>(smem);  // the exchange tile (none for one group)
  void *TB = T + p.tile_words;             // the range's stage-table slice
  // the slice's inter-step twiddle row (where a leaf / mid range multiplies
  // it), or the lane tile's staged twiddle
  void *TW = reinterpret_cast<unsigned char *>(TB) + p.tab_entries * (MM == 2 ? 8 : 16);
  for (int e = threadIdx.x; e < p.tab_entries; e += blockDim.x) {
    const int i = p.tab_lo + e;
    if constexpr (MM == 2)
      reinterpret_cast<u64 *>(TB)[e] = __ldg(p.w + i);
    else
      reinterpret_cast<ulonglong2 *>(TB)[e] = make_ulonglong2(__ldg(p.w + i), __ldg(p.wp + i));
  }
  __syncthreads();
  if constexpr (LANE)
    lane_tiles<INV, MM, LAZY, RMAX>(p, T, TB, reinterpret_cast<u64 *>(TW));
  else
    leaf_tiles<INV, MM, LAZY, RMAX, SWZ>(p, T, TB, TW);
}

template <bool INV, int MM, bool LAZY, int RMAX, bool SWZ, bool LANE>
cudaError_t launch_r2(const R2Args &p, int threads, int smem, cudaStream_t stream) {
  const long long work = ((p.B + (1ll << p.log2c) - 1) >> p.log2c) * p.A;
  return launch_resident(radix2_reg_kernel<INV, MM, LAZY, RMAX, SWZ, LANE>, p, threads, smem,
                         work, stream);
}

}  // namespace

// The register kernel on stages [first, last) of the compact tables w / wp
// along axis 1 of the (A, m, B) view (element strides sa, sm, sb).  Leaf /
// mid: the inter-step twiddle (tw_mode 1 "pair", 2 "w", 3 Solinas) at
// tw_w[a ta + j tm], broadcast over the columns.  Lane (`lane`): every
// stage of contiguous rows, A = 1, sm = 1, sb = m, the twiddle of the
// data's layout (ta = m, tm = 1).  ranks / log2c / threads / smem:
// butterfly_geometry's groups (4 bits each), tile of 2^log2c batch entries,
// block and shared memory, which must equal this layout's: the exchange
// tile of 2^(log2c + log2m) words where there are two groups or more, the
// range's slice of the stage tables, entries [lmin - 1, 2 lmax - 1) of the
// half-widths it runs, 16 bytes an entry (8 under Solinas), and, where a
// leaf / mid range multiplies the twiddle (forward from stage 0, inverse to
// the last), a row of m twiddles, 16 bytes an entry "pair" and 8 otherwise.
extern "C" int sventt_radix2_ntt(
    const void *x, void *out, const void *w, const void *wp, const void *tw_w,
    const void *tw_wp, long long A, int log2m, long long B, long long sa, long long sm,
    long long sb, long long ta, long long tm, int first, int last, unsigned long long ranks,
    int log2c, int threads, int smem, int inverse, int lane, int modmul, int lazy, int tw_mode,
    unsigned long long N, unsigned long long ninv, unsigned long long s,
    unsigned long long sp, void *stream) {
  if (A <= 0 || B <= 0 || log2m < 1 || log2m > 12 || first < 0 || first >= last ||
      last > log2m || log2c < 0 || log2c > 16 || tw_mode < 0 || tw_mode > 3 ||
      (tw_mode != 0 && tw_w == nullptr) || ((tw_mode == 1) != (tw_wp != nullptr)) ||
      modmul < 0 || modmul > 2 || (modmul == 1 && !lazy) ||
      // Solinas: canonical, companion-free stages, its own inter-step mode;
      // and only Solinas takes that mode
      (modmul == 2 && (lazy || wp != nullptr || (tw_mode != 0 && tw_mode != 3))) ||
      (modmul != 2 && (wp == nullptr || tw_mode == 3)) ||
      // the lane: whole contiguous rows, the twiddle in their layout
      (lane && (A != 1 || sm != 1 || sb != 1ll << log2m || first != 0 || last != log2m ||
                (tw_mode != 0 && (ta != 1ll << log2m || tm != 1)))))
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
  const long long tab_bytes = (long long)tab_entries * (modmul == 2 ? 8 : 16);
  const long long tw_bytes = 8ll * (tw_mode == 1 ? 2 : 1) * (lane ? tile_words : 1ll << log2m);
  // the lane inverse stages a tile's twiddle where it fits beside the tile
  const bool staged = lane && inverse && fused && ngroups > 1 &&
                      8 * tile_words + tab_bytes + tw_bytes <= MAX_SMEM;
  const long long want = 8 * tile_words + tab_bytes + (fused && (staged || !lane) ? tw_bytes : 0);
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
  p.staged = staged;
  cudaStream_t st = (cudaStream_t)stream;
  const bool swz = log2c < 4;  // a half-warp spans several points below 16 columns
#define SVENTT_LAUNCH_RMAX(INV, MM, LAZY, SWZ, LANE)                                    \
  (rmax <= 3 ? launch_r2<INV, MM, LAZY, 3, SWZ, LANE>(p, threads, smem, st)             \
             : launch_r2<INV, MM, LAZY, 4, SWZ, LANE>(p, threads, smem, st))
#define SVENTT_LAUNCH_R(INV, MM, LAZY)                                                  \
  (lane ? SVENTT_LAUNCH_RMAX(INV, MM, LAZY, true, true)                                 \
        : swz ? SVENTT_LAUNCH_RMAX(INV, MM, LAZY, true, false)                          \
              : SVENTT_LAUNCH_RMAX(INV, MM, LAZY, false, false))
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
#undef SVENTT_LAUNCH_RMAX
  return (int)e;
}
