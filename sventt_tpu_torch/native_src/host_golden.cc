// Native host-side golden NTT and field helpers: the port's own copy of
// sventt_tpu/native/host_golden.cc, unchanged below this comment.
//
// C++ analogue of the reference's exact oracle (reference
// tests/ntt-reference.hpp: naive radix-2 NTT over unsigned __int128,
// canonical [0, N), DIF forward emitting bit-reversed order, DIT inverse
// pre-scaled by m^-1).  The Python golden model (field/golden.py) is the
// semantic source of truth; this library reproduces it at native speed so
// large-n transforms (2^17+) can be verified against an independent oracle
// in milliseconds instead of minutes.  Built with c++ and loaded via ctypes
// by sventt_tpu_torch/native.py, which raises when it cannot be built.

#include <cstdint>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

extern "C" {

static u64 mulmod(u64 a, u64 b, u64 N) { return (u128)a * b % N; }

// Addition/subtraction via u128: a + b and a + N - b overflow u64 when
// bit_width(N) == 64 (e.g. the flagship modulus 0xffff'fc6e'8000'0001).
static u64 addmod(u64 a, u64 b, u64 N) { return (u64)(((u128)a + b) % N); }
static u64 submod(u64 a, u64 b, u64 N) {
  return (u64)(((u128)a + N - b) % N);
}

static u64 powmod(u64 a, u64 e, u64 N) {
  u64 r = 1 % N;
  a %= N;
  while (e) {
    if (e & 1) r = mulmod(r, a, N);
    a = mulmod(a, a, N);
    e >>= 1;
  }
  return r;
}

u64 sventt_powmod(u64 a, u64 e, u64 N) { return powmod(a, e, N); }

u64 sventt_invmod(u64 a, u64 N) { return powmod(a, N - 2, N); }

// Forward DIF NTT in place: data[0..m), canonical residues in, canonical
// out, bit-reversed order (tests/ntt-reference.hpp:43-61 semantics).
// omega_m: primitive m-th root g^((N-1)/m).  Returns 0 on success.
int sventt_golden_forward(u64 *data, u64 m, u64 N, u64 omega_m) {
  if (m == 0 || (m & (m - 1))) return 1;
  u64 omega_2l = omega_m;
  for (u64 l = m >> 1; l >= 1; l >>= 1) {
    u64 w = 1;
    for (u64 j = 0; j < l; ++j) {
      for (u64 k = j; k < m; k += l << 1) {
        u64 x0 = data[k], x1 = data[k + l];
        data[k] = addmod(x0, x1, N);
        data[k + l] = mulmod(submod(x0, x1, N), w, N);
      }
      w = mulmod(w, omega_2l, N);
    }
    omega_2l = mulmod(omega_2l, omega_2l, N);
    if (l == 1) break;
  }
  return 0;
}

// Inverse DIT NTT in place: consumes bit-reversed order, emits natural
// order scaled by m^-1 (tests/ntt-reference.hpp:63-83 semantics).
int sventt_golden_inverse(u64 *data, u64 m, u64 N, u64 omega_m) {
  if (m == 0 || (m & (m - 1))) return 1;
  u64 minv = powmod(m % N, N - 2, N);
  u64 omegainv_m = powmod(omega_m, N - 2, N);
  for (u64 i = 0; i < m; ++i) data[i] = mulmod(data[i], minv, N);
  u64 log2m = 0;
  while ((u64(1) << log2m) < m) ++log2m;
  for (u64 s = 0; s < log2m; ++s) {
    u64 l = u64(1) << s;
    u64 omegainv_2l = powmod(omegainv_m, u64(1) << (log2m - s - 1), N);
    u64 w = 1;
    for (u64 j = 0; j < l; ++j) {
      for (u64 k = j; k < m; k += l << 1) {
        u64 x0 = data[k];
        u64 x1 = mulmod(data[k + l], w, N);
        data[k] = addmod(x0, x1, N);
        data[k + l] = submod(x0, x1, N);
      }
      w = mulmod(w, omegainv_2l, N);
    }
  }
  return 0;
}

// Cyclic convolution oracle: c = a (*) b mod N via schoolbook O(m^2)
// (fully independent of any NTT code path, for application-level checks).
int sventt_cyclic_convolve_naive(const u64 *a, const u64 *b, u64 *c, u64 m,
                                 u64 N) {
  for (u64 k = 0; k < m; ++k) {
    u128 acc = 0;
    for (u64 j = 0; j < m; ++j) {
      u64 idx = (k + m - j) % m;
      acc += (u128)(mulmod(a[j], b[idx], N));
      if ((j & 0xff) == 0xff) acc %= N;
    }
    c[k] = (u64)(acc % N);
  }
  return 0;
}

// Montgomery / Shoup companions (host table generation parity helpers).
u64 sventt_montgomery_inverse(u64 N) {
  // Newton iteration for N^-1 mod 2^64 (reference modulus.hpp:36-68 role).
  u64 inv = N;  // correct mod 2^3 for odd N
  for (int i = 0; i < 5; ++i) inv *= 2 - N * inv;
  return inv;
}

u64 sventt_shoup_precompute(u64 w, u64 N) {
  return (u64)((((u128)w) << 64) / N);
}

}  // extern "C"
