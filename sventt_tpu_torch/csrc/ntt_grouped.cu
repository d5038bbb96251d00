// Radix-2^R grouped NTT for Hopper (sm_90a): one kernel, two orientations.
//
// Replaces the Pallas kernels of sventt_tpu/ops/ntt_pallas.py that the
// engine "pallas" runs with max_r > 1:
//   K7 _grouped_call (body _make_grouped_kernel): one radix-2^R group along
//      axis 0 of (m, B), one pallas_call per group -- every leaf, and every
//      inner row step (the planner's transpose fallback);
//   K8 _lane_grouped_call (body _lane_grouped_kernel): every group along
//      the last axis of (rows, m), partners found by lane rolls, the
//      inter-step twiddle fused -- the unbatched root row step.
// The plain PyTorch version is sventt_tpu_torch/ops/ntt_pallas.py::
// _groups_plain; the two agree bit for bit.
//
// Layout and tiling are those of csrc/ntt_pallas.cu: an (A, m, B) view with
// element strides, a block loads `cols` batch entries (columns for the
// leaf, whole rows for the lane) of all m points into shared memory, runs
// EVERY group there rank by rank with __syncthreads() between ranks, and
// writes once: one launch per leaf, where the TPU issued one per group for
// Mosaic's sake.  Rank partners j0 and j0 + h are read from shared memory
// (no roll and select); the ragged batch is masked (the JAX wrappers pad
// to 256 columns or 64 rows).
//
// Group g covers R ranks; `ranks` holds R at bits [4g, 4g + 4).  Forward
// rank s has half-width h = l >> s (l = m >> (s0 + 1), s0 stages before the
// group), inverse h = 2^s * L (L = 2^s0); L = h of the last forward / first
// inverse rank.  The scalar constant of rank s, sub-slice low = (j0 mod h)
// / L is cst[g][s][low] = (w, wp), absent where cmask is 0 (exponent 0);
// the combined table tab[g][j] multiplies both outputs of the last forward
// rank and both inputs of the first inverse rank.  Per butterfly:
//   forward  (x0 + x1, c * (x0 - x1)) -- K7 biases a lazy difference by
//            +2N unreduced where a constant follows, K8 (lane = 1) reduces
//            it with sub; last rank: y0 *= tab[j0], y1 *= tab[j0 + h]
//   inverse  first rank: x0 *= tab[j0], t = x1 * tab[j0 + h]; later ranks:
//            t = c * x1; then (x0 + t, x0 - t)
// K7 skips the table multiply on a first point whose combined exponent is
// 0 (its index within the table's span is below L), unless the group
// holds the inverse 1/m; K8 multiplies every point.  Same residues, and
// with a lazy modulus each orientation keeps its JAX kernel's bits.  Stage
// and constant multiplies are Montgomery or Shoup (template MM); the fused
// inter-step twiddle is Montgomery (field.cuh inter_step_mul, tw_mode 1 or
// 2).  Solinas never reaches this kernel: it forces max_r = 1.
//
// What bounds it on the H100: 16 bytes a point (32 with a "pair" twiddle of
// the data's size, as the lane root step has) against, per point, one
// table multiply per group and a constant multiply on part of the ranks'
// differences -- about 4.5 64-bit products a point at m = 256, max_r = 3,
// each several 32-bit IMADs.  At the 2^24 plan's shapes HBM bounds it.
// This first version keeps csrc/ntt_pallas.cu's simple schedule (plain
// loads, one thread per butterfly per rank, rows padded by one word);
// keeping a whole group's 2^R points of a butterfly set in registers would
// cut the shared-memory round trips from R to 1 per group, later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = 4;                 // ranks a group may have
constexpr int MAX_LOWS = 1 << (MAX_R - 1);  // constants a rank may have

template <bool INV, int MM, bool LAZY>
__global__ void __launch_bounds__(THREADS)
    grouped_kernel(const long long *__restrict__ x, long long *__restrict__ out,
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
    for (int idx = threadIdx.x; idx < tile; idx += THREADS) {
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
        for (int idx = threadIdx.x; idx < tile >> 1; idx += THREADS) {
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

    for (int idx = threadIdx.x; idx < tile; idx += THREADS) {
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
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const long long *x,
                   long long *out, const unsigned long long *tab,
                   const unsigned long long *tabp, const unsigned long long *cst,
                   const unsigned char *cmask, const long long *tw_w,
                   const long long *tw_wp, long long A, int log2m, long long B,
                   long long sa, long long sm, long long sb, long long ta, long long tm,
                   long long tb, int ngroups, unsigned long long ranks, int log2c,
                   int lane, int tw_mode, u64 N, u64 ninv) {
  auto kern = grouped_kernel<INV, MM, LAZY>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, THREADS, smem, stream>>>(x, out, tab, tabp, cst, cmask, tw_w, tw_wp, A,
                                        log2m, B, sa, sm, sb, ta, tm, tb, ngroups, ranks,
                                        log2c, lane, tw_mode, N, ninv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sventt_grouped_ntt(
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
  launch<INV, MM, LAZY>(grid, smem, st, xp, op, tq, tpq, cq, mq, wq, wpq, A, log2m, B, \
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
