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
