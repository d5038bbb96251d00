// u64 prime-field device functions: the CUDA counterpart of
// sventt_tpu_torch/field/limb.py (and of sventt_tpu/field/limb.py, whose
// (hi, lo) u32 limb chains Hopper replaces with native 64-bit words and
// __umul64hi).  Every function gives the bit-identical result of its
// Python counterpart.
#pragma once

#include <cstdint>

typedef unsigned long long u64;

// a + b with the carry-out bit in `carry` (0 or 1).
__device__ __forceinline__ u64 add_carry(u64 a, u64 b, u64 &carry) {
  u64 s = a + b;
  carry = s < a;
  return s;
}

// ab1 - hi64(q*N): +N always when lazy ((0, 2N) result), else +N on borrow
// (canonical [0, N)) -- FieldConsts._redc_finish.
__device__ __forceinline__ u64 redc_finish(u64 ab1, u64 q, u64 N, bool lazy) {
  u64 qn1 = __umul64hi(q, N);
  u64 d = ab1 - qn1;
  if (lazy) return d + N;
  return ab1 < qn1 ? d + N : d;
}

// Montgomery multiply with a precomputed companion wp = w * N^-1 mod 2^64.
__device__ __forceinline__ u64 mont_mul(u64 a, u64 w, u64 wp, u64 N, bool lazy) {
  return redc_finish(__umul64hi(a, w), a * wp, N, lazy);
}

// Montgomery multiply computing the companion in flight (ninv = N^-1 mod 2^64).
__device__ __forceinline__ u64 mont_mul_full(u64 a, u64 b, u64 N, u64 ninv,
                                             bool lazy) {
  return redc_finish(__umul64hi(a, b), (a * b) * ninv, N, lazy);
}

// [0, 2N) -> [0, N) (identity for canonical values).
__device__ __forceinline__ u64 normalize(u64 a, u64 N) {
  return a < N ? a : a - N;
}

__device__ __forceinline__ u64 u64_min(u64 a, u64 b) { return a < b ? a : b; }

// a + b in range: lazy [0, 2N) by the min-trick (4N < 2^64), canonical
// [0, N) with a carry-aware wrap -- FieldConsts.add.
__device__ __forceinline__ u64 add_mod(u64 a, u64 b, u64 N, bool lazy) {
  if (lazy) {
    const u64 s = a + b;
    return u64_min(s, s - 2 * N);
  }
  u64 carry;
  const u64 s = add_carry(a, b, carry);
  return (carry || s >= N) ? s - N : s;
}

// a - b in range: lazy a - b + 2N then the min-trick, canonical +N on
// borrow -- FieldConsts.sub.
__device__ __forceinline__ u64 sub_mod(u64 a, u64 b, u64 N, bool lazy) {
  if (lazy) {
    const u64 d = a - b + 2 * N;
    return u64_min(d, d - 2 * N);
  }
  const u64 d = a - b;
  return a < b ? d + N : d;
}

// Shoup multiply a*w - hi64(a*wp)*N in [0, 2N), w plain, wp =
// floor(w * 2^64 / N); canonical mode subtracts N once more --
// FieldConsts.shoup_mul.
__device__ __forceinline__ u64 shoup_mul(u64 a, u64 w, u64 wp, u64 N, bool lazy) {
  const u64 c = a * w - __umul64hi(a, wp) * N;
  return lazy ? c : u64_min(c, c - N);
}

// Solinas multiply a*w mod N, canonical [0, N), for a plain w, any a, and
// a sparse-high N = 2^64 - eps, eps = c*2^s - 1 of at most 42 bits
// (flagship: c = 1827, s = 31; Goldilocks: c = 1, s = 32) --
// FieldConsts.solinas_mul.  2^64 === eps (mod N) folds the high word of
// the 128-bit product: after fold 1 it is <= 2^42, after fold 2 <= 2^20,
// so fold 3's hi*eps < 2^62 fits one word, and its carry out, one more
// 2^64 === eps, adds without a new carry (the wrapped sum is < 2^62).
// Every fold is exact, so this is the bit-identical canonical result of
// the JAX package's limb chain whatever s is.  No companion: eps = -N.
__device__ __forceinline__ u64 solinas_mul(u64 a, u64 w, u64 N) {
  const u64 eps = 0ull - N;
  u64 c;
  u64 lo = a * w, hi = __umul64hi(a, w);
  lo = add_carry(lo, hi * eps, c);
  hi = __umul64hi(hi, eps) + c;
  lo = add_carry(lo, hi * eps, c);
  hi = __umul64hi(hi, eps) + c;
  u64 r = add_carry(lo, hi * eps, c);
  r += c ? eps : 0ull;
  return u64_min(r, r - N);
}

// Stage-twiddle multiply by the configured engine (MM 0 Montgomery, 1
// Shoup, 2 Solinas: wp unread, never lazy) -- FieldConsts.twiddle_mul.
template <int MM>
__device__ __forceinline__ u64 twiddle_mul(u64 a, u64 w, u64 wp, u64 N, bool lazy) {
  if constexpr (MM == 2) return solinas_mul(a, w, N);
  if constexpr (MM == 1) return shoup_mul(a, w, wp, N, lazy);
  return mont_mul(a, w, wp, N, lazy);
}

// The six-step inter-step multiply of v by twiddle i by the engine `mode`:
// 1 Montgomery with the companion table wp ("pair"), 2 Montgomery
// computing it in flight ("w"), 3 Solinas on plain twiddles ("w", wp
// unread) -- ops/twiddle.py::inter_step_mul.
__device__ __forceinline__ u64 inter_step_mul(u64 v, const long long *w,
                                              const long long *wp, long long i, int mode,
                                              u64 N, u64 ninv, bool lazy) {
  if (mode == 3) return solinas_mul(v, (u64)w[i], N);
  if (mode == 1) return mont_mul(v, (u64)w[i], (u64)wp[i], N, lazy);
  return mont_mul_full(v, (u64)w[i], N, ninv, lazy);
}
