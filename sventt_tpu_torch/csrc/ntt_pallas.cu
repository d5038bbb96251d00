// Radix-2 butterfly NTT for Hopper (sm_90a): one kernel, three orientations.
//
// Replaces the Pallas kernels of sventt_tpu/ops/ntt_pallas.py that the
// engine "pallas" runs with its default max_r = 1:
//   K4 _group_call (body _make_group_kernel / _stage_one): stages along
//      axis 0 of (m, B) -- every column leaf;
//   K5 _mid_call: the same along axis 1 of (A, m, B) -- inner row steps;
//   K6 _lane_call (body _lane_kernel): stages along the last axis of
//      (rows, m) -- the unbatched root row step.
// The plain PyTorch version is sventt_tpu_torch/ops/ntt_pallas.py::
// _stages_plain; the two agree bit for bit.  K4, K5 and K6 run on the
// register kernel csrc/ntt_radix2.cu; this kernel, the first port's, stays
// only as their A/B point (ntt_pallas._launch_stages), in all three
// orientations, and no path runs it.
//
// The data is an (A, m, B) view with element strides (sa, sm, sb); the
// transform runs along m.  Leaf is A = 1, B columns of stride 1; mid is A
// slices; lane is A = 1 with the rows as B batch entries of stride m and
// transform stride 1.  A block takes a tile of `cols` batch entries of one
// slice, loads all m points of each into shared memory (coalesced: along
// the batch for leaf/mid, along the transform axis for lane), runs the
// stages [first, last) there with __syncthreads() between stages, and
// writes once.  On the TPU each leaf was split into pallas_calls of <= 5
// stages for Mosaic's compile time and its tables pre-broadcast to vreg
// tiles; here a whole leaf (m <= 256: 32 KB for 16 columns) fits in shared
// memory, the default is one launch per leaf, and the stage tables are
// compact: the (m-1,) vectors w and wp, stage l at [l-1, 2l-1), read
// through __ldg.  A stage range still splits a leaf when stages_per_call
// asks for it.
//
// Arithmetic, per butterfly (x0, x1) with twiddle (w, wp):
//   forward  K4/K5: (x0 + x1, (x0 - x1 [+2N unreduced when lazy]) * w)
//            K6:    (x0 + x1, sub(x0, x1) * w)   (lane = 1)
//   inverse  t = x1 * w: (x0 + t, x0 - t); the last stage (1/m folded)
//            a = x0 * s, b = x1 * sw: (a + b, a - b)
// The two forward sequences give the same residue but, with a lazy
// modulus, not always the same [0, 2N) bits; each orientation keeps the
// bits of the JAX kernel it replaces.  The stage multiply is Montgomery,
// Shoup or Solinas (template MM 0 / 1 / 2).  Solinas (modmul="solinas":
// _stage_one with aps = 2, apply_pre's solinas_mul) is canonical only, its
// tables are plain and companion-free: the wp vector and sp are not read,
// half the stage-table bytes.  The fused inter-step twiddle (tw_mode 1
// "pair" = mont_mul, 2 "w" = mont_mul_full, 3 Solinas "w" = solinas_mul)
// runs before the stages on the forward and after them on the inverse.
// The ragged batch edge is masked here (the JAX wrappers pad to 256
// columns or 64 rows).
//
// What bounds it on the H100: every point is read and written once (16
// bytes; 32 with a "pair" inter-step twiddle of the data's size, as the
// lane root step has) against, per point and stage, half a stage multiply
// (two or three 64-bit products, each several 32-bit IMADs) and the add/sub
// chains.  At m = 256 that is ~22 64-bit products a point against 16-32
// bytes: the integer pipes, not HBM at 3.35 TB/s, bound it once the loads
// are hidden.  This first version keeps it simple: plain loads, one
// thread per butterfly per stage, shared-memory rows padded by one word
// against bank conflicts; csrc/ntt_radix2.cu keeps a column's (leaf, mid)
// or a row's (lane) stages in registers.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int THREADS = 256;

struct Consts {
  u64 N, ninv, s, sp;
};

template <bool INV, int MM, bool LAZY>
__global__ void __launch_bounds__(THREADS)
    butterfly_kernel(const long long *__restrict__ x, long long *__restrict__ out,
                     const unsigned long long *__restrict__ w,
                     const unsigned long long *__restrict__ wp,
                     const long long *__restrict__ tw_w,
                     const long long *__restrict__ tw_wp, long long A, int log2m,
                     long long B, long long sa, long long sm, long long sb,
                     long long ta, long long tm, long long tb, int first, int last,
                     int log2c, int lane, int tw_mode, Consts k) {
  extern __shared__ __align__(16) unsigned char smem[];
  // T[j * P + c]: point j of tile column c; the +1 word of padding spreads
  // the lane orientation's column-strided stores over the banks.
  u64 *T = reinterpret_cast<u64 *>(smem);
  const int m = 1 << log2m;
  const int cols = 1 << log2c;
  const int P = cols + 1;
  const int tile = m << log2c;
  const long long c0 = (long long)blockIdx.x << log2c;
  const bool prologue = tw_mode != 0 && !INV && first == 0;
  const bool epilogue = tw_mode != 0 && INV && last == log2m;

  for (long long a = blockIdx.y; a < A; a += gridDim.y) {
    __syncthreads();  // the previous slice is done with T
    for (int idx = threadIdx.x; idx < tile; idx += THREADS) {
      const int c = lane ? idx >> log2m : idx & (cols - 1);
      const int j = lane ? idx & (m - 1) : idx >> log2c;
      const long long col = c0 + c;
      u64 v = 0;
      if (col < B) {
        v = (u64)x[a * sa + j * sm + col * sb];
        if (prologue)
          v = inter_step_mul(v, tw_w, tw_wp, a * ta + j * tm + col * tb, tw_mode, k.N,
                             k.ninv, LAZY);
      }
      T[j * P + c] = v;
    }
    __syncthreads();

    for (int s = first; s < last; ++s) {
      const int l = INV ? 1 << s : m >> (s + 1);
      const bool scaled = INV && s == log2m - 1;
      const unsigned long long *ws = w + (l - 1);
      const unsigned long long *wps = wp + (l - 1);
      for (int idx = threadIdx.x; idx < tile >> 1; idx += THREADS) {
        const int c = idx & (cols - 1);
        const int bi = idx >> log2c;  // butterfly index within the column
        const int j = bi & (l - 1);
        u64 *p0 = T + (((bi - j) << 1) + j) * P + c;
        u64 *p1 = p0 + l * P;
        const u64 x0 = *p0, x1 = *p1;
        const u64 tw = __ldg(ws + j);
        const u64 twp = MM == 2 ? 0ull : __ldg(wps + j);
        u64 y0, y1;
        if (!INV) {
          y0 = add_mod(x0, x1, k.N, LAZY);
          const u64 d = (LAZY && !lane) ? x0 - x1 + 2 * k.N : sub_mod(x0, x1, k.N, LAZY);
          y1 = twiddle_mul<MM>(d, tw, twp, k.N, LAZY);
        } else if (scaled) {
          const u64 a0 = twiddle_mul<MM>(x0, k.s, k.sp, k.N, LAZY);
          const u64 b1 = twiddle_mul<MM>(x1, tw, twp, k.N, LAZY);
          y0 = add_mod(a0, b1, k.N, LAZY);
          y1 = sub_mod(a0, b1, k.N, LAZY);
        } else {
          const u64 t = twiddle_mul<MM>(x1, tw, twp, k.N, LAZY);
          y0 = add_mod(x0, t, k.N, LAZY);
          y1 = sub_mod(x0, t, k.N, LAZY);
        }
        *p0 = y0;
        *p1 = y1;
      }
      __syncthreads();
    }

    for (int idx = threadIdx.x; idx < tile; idx += THREADS) {
      const int c = lane ? idx >> log2m : idx & (cols - 1);
      const int j = lane ? idx & (m - 1) : idx >> log2c;
      const long long col = c0 + c;
      if (col < B) {
        u64 v = T[j * P + c];
        if (epilogue)
          v = inter_step_mul(v, tw_w, tw_wp, a * ta + j * tm + col * tb, tw_mode, k.N,
                             k.ninv, LAZY);
        out[a * sa + j * sm + col * sb] = (long long)v;
      }
    }
  }
}

template <bool INV, int MM, bool LAZY>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const long long *x,
                   long long *out, const unsigned long long *w,
                   const unsigned long long *wp, const long long *tw_w,
                   const long long *tw_wp, long long A, int log2m, long long B,
                   long long sa, long long sm, long long sb, long long ta, long long tm,
                   long long tb, int first, int last, int log2c, int lane, int tw_mode,
                   const Consts &k) {
  auto kern = butterfly_kernel<INV, MM, LAZY>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, THREADS, smem, stream>>>(x, out, w, wp, tw_w, tw_wp, A, log2m, B, sa,
                                        sm, sb, ta, tm, tb, first, last, log2c, lane,
                                        tw_mode, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sventt_butterfly_ntt(
    const void *x, void *out, const void *w, const void *wp, const void *tw_w,
    const void *tw_wp, long long A, int log2m, long long B, long long sa,
    long long sm, long long sb, long long ta, long long tm, long long tb, int first,
    int last, int log2c, int inverse, int modmul, int lazy, int lane, int tw_mode,
    unsigned long long N, unsigned long long ninv, unsigned long long s,
    unsigned long long sp, void *stream) {
  if (A <= 0 || B <= 0 || log2m < 1 || log2m > 12 || log2c < 0 || log2c > 16 ||
      first < 0 || first >= last || last > log2m || tw_mode < 0 ||
      (tw_mode != 0 && tw_w == nullptr) || ((tw_mode == 1) != (tw_wp != nullptr)) ||
      modmul < 0 || modmul > 2 || (modmul == 1 && !lazy) ||
      // Solinas: canonical, companion-free stages, its own inter-step mode;
      // and only Solinas takes that mode
      (modmul == 2 && (lazy || wp != nullptr || (tw_mode != 0 && tw_mode != 3))) ||
      (modmul != 2 && (wp == nullptr || tw_mode == 3)) || tw_mode > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (((size_t)1 << log2c) + 1) * ((size_t)1 << log2m) * sizeof(u64);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const long long gy = A < 65535 ? A : 65535;
  const dim3 grid((unsigned)((B + (1ll << log2c) - 1) >> log2c), (unsigned)gy);
  const Consts k{N, ninv, s, sp};
  cudaStream_t st = (cudaStream_t)stream;
  const auto *xp = (const long long *)x;
  auto *op = (long long *)out;
  const auto *wq = (const unsigned long long *)w;
  const auto *wpq = (const unsigned long long *)wp;
  const auto *tq = (const long long *)tw_w;
  const auto *tpq = (const long long *)tw_wp;
#define SVENTT_LAUNCH(INV, MM, LAZY)                                                  \
  launch<INV, MM, LAZY>(grid, smem, st, xp, op, wq, wpq, tq, tpq, A, log2m, B, sa, sm, \
                        sb, ta, tm, tb, first, last, log2c, lane, tw_mode, k)
  cudaError_t e;
  if (modmul == 2)  // Solinas is canonical only (64-bit moduli)
    e = inverse ? SVENTT_LAUNCH(true, 2, false) : SVENTT_LAUNCH(false, 2, false);
  else if (modmul == 1)  // Shoup is lazy only (FieldConsts.from_modulus)
    e = inverse ? SVENTT_LAUNCH(true, 1, true) : SVENTT_LAUNCH(false, 1, true);
  else if (lazy)
    e = inverse ? SVENTT_LAUNCH(true, 0, true) : SVENTT_LAUNCH(false, 0, true);
  else
    e = inverse ? SVENTT_LAUNCH(true, 0, false) : SVENTT_LAUNCH(false, 0, false);
#undef SVENTT_LAUNCH
  return (int)e;
}
