// Native host-side q-series generators: the port's own copy of the JAX
// package's series.cc, unchanged below this header but for its build note.
//
// C++ analogue of the reference's streaming polynomial generators
// (reference examples/magic-series/restricted-partition.hpp:37-50 rolling
// DP; examples/magic-series/gaussian-polynomial.hpp:19-45 q-Pochhammer and
// :52-146 Rothe-identity numerator segments).  The host side of the
// magic-series pipeline feeds coefficient blocks to the device NTT; these
// generators produce them at native speed with the reference's bounded
// state: the restricted-partition stream keeps O(k^2) ring-buffer words
// regardless of how far it streams, and the numerator is evaluated per
// coefficient RANGE from its k+1 Rothe segments instead of materializing
// the full degree-r polynomial.
//
// All coefficients are canonical residues mod N (N < 2^64, prime not
// required here); arithmetic via unsigned __int128.
//
// Build: sventt_tpu_torch/native.py compiles it with host_golden.cc into
// one library in the port's build directory, and raises when it cannot.

#include <cstdint>
#include <cstdlib>
#include <cstring>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

namespace {

inline u64 addmod(u64 a, u64 b, u64 N) { return (u64)(((u128)a + b) % N); }
inline u64 submod(u64 a, u64 b, u64 N) {
  return (u64)(((u128)a + N - b) % N);
}
inline u64 mulmod(u64 a, u64 b, u64 N) { return (u64)((u128)a * b % N); }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// (q;q)_k coefficients [0..degree], iterated multiplication by (1 - q^i)
// (reference gaussian-polynomial.hpp:19-45).
// ---------------------------------------------------------------------------
int sventt_qpochhammer(u64 *out, u64 degree_plus1, u64 k, u64 N) {
  if (degree_plus1 == 0) return 1;
  std::memset(out, 0, degree_plus1 * sizeof(u64));
  out[0] = 1 % N;
  for (u64 i = 1; i <= k && i < degree_plus1; ++i)
    for (u64 j = degree_plus1; j-- > i;)
      out[j] = submod(out[j], out[j - i], N);
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming restricted-partition series: coefficients of 1/(q;q)_k, i.e.
// p(n | parts <= k).  Recurrence p(n, j) = p(n, j-1) + p(n - j, j): level j
// needs its own output lagged by j, so the stream state is k ring buffers
// of sizes 1..k -- k(k+1)/2 words total, the reference's rolling
// (k+1)x(k+1) table (restricted-partition.hpp:37-50) without the unused
// triangle.  next() emits any number of coefficients; memory never grows.
// ---------------------------------------------------------------------------
struct SventtRpStream {
  u64 N;
  u64 k;
  u64 n;      // index of the next coefficient to emit
  u64 *ring;  // concatenated ring buffers, level j at ring + j*(j-1)/2
};

SventtRpStream *sventt_rp_create(u64 k, u64 N) {
  if (k == 0 || N == 0) return nullptr;
  auto *s = (SventtRpStream *)std::malloc(sizeof(SventtRpStream));
  if (!s) return nullptr;
  s->N = N;
  s->k = k;
  s->n = 0;
  s->ring = (u64 *)std::calloc(k * (k + 1) / 2, sizeof(u64));
  if (!s->ring) {
    std::free(s);
    return nullptr;
  }
  return s;
}

void sventt_rp_destroy(SventtRpStream *s) {
  if (!s) return;
  std::free(s->ring);
  std::free(s);
}

// Emit the next ``count`` coefficients p(n | parts <= k) into out.
int sventt_rp_next(SventtRpStream *s, u64 *out, u64 count) {
  if (!s || !out) return 1;
  const u64 N = s->N, k = s->k;
  for (u64 c = 0; c < count; ++c, ++s->n) {
    const u64 n = s->n;
    // p(n, 0) = [n == 0]
    u64 prev = (n == 0) ? 1 % N : 0;
    for (u64 j = 1; j <= k; ++j) {
      u64 *rj = s->ring + j * (j - 1) / 2;  // ring buffer of size j
      u64 slot = n % j;
      // rj[slot] currently holds p(n - j, j) (zero for n < j)
      u64 v = addmod(prev, rj[slot], N);
      rj[slot] = v;  // becomes the lag-j value for n + j
      prev = v;
    }
    out[c] = prev;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Gaussian-binomial numerator prod_{i=n-k+1}^{n} (1 - q^i) by Rothe
// segments: the q-binomial theorem gives
//
//   prod_{i=0}^{k-1} (1 - a q^i) = sum_{j=0}^{k} (-1)^j q^(j(j-1)/2)
//                                  qbinom(k, j) a^j ,
//
// so with a = q^(n-k+1) the numerator is the sum of k+1 SEGMENTS: segment j
// is (-1)^j qbinom_j(q) shifted to offset j(n-k+1) + j(j-1)/2, where
// qbinom_j = qbinom(k, j) has degree j(k-j) <= k^2/4 (reference
// gaussian-polynomial.hpp:52-146 streams exactly these segments).  A
// coefficient RANGE [lo, lo+count) is evaluated by adding the overlapping
// part of each segment -- O(k^2/4) words per segment, never the full
// degree-r polynomial.
// ---------------------------------------------------------------------------

// qbinom(k, j) coefficients [0 .. j*(k-j)] via the Pascal recurrence
// qbinom(m, j) = qbinom(m-1, j-1) * q^(m-j)... using the standard DP over
// restricted partitions in a j x (k-j) box: coeff[d] = #partitions of d
// with at most j parts each <= k-j, computed mod N.
static int qbinom_coeffs(u64 k, u64 j, u64 N, u64 *out /* size j*(k-j)+1 */) {
  const u64 deg = j * (k - j);
  std::memset(out, 0, (deg + 1) * sizeof(u64));
  out[0] = 1 % N;
  // multiply by (1 - q^(k-j+i)) / (1 - q^i) for i = 1..j, truncated at deg:
  // numerator factor then exact division by (1 - q^i) (series division is
  // exact for q-binomials).
  for (u64 i = 1; i <= j; ++i) {
    const u64 a = k - j + i;
    for (u64 d = deg + 1; d-- > a;) out[d] = submod(out[d], out[d - a], N);
    // divide by (1 - q^i): out[d] += out[d - i] running forward
    for (u64 d = i; d <= deg; ++d) out[d] = addmod(out[d], out[d - i], N);
  }
  return 0;
}

int sventt_gauss_numerator_range(u64 *out, u64 lo, u64 count, u64 n, u64 k,
                                 u64 N) {
  if (!out || k > n) return 1;
  std::memset(out, 0, count * sizeof(u64));
  if (count == 0) return 0;
  const u64 hi = lo + count;  // exclusive
  const u64 boxdeg = (k / 2) * (k - k / 2);
  u64 *qb = (u64 *)std::malloc((boxdeg + 1) * sizeof(u64));
  if (!qb) return 2;
  for (u64 j = 0; j <= k; ++j) {
    const u64 off = j * (n - k + 1) + j * (j - 1) / 2;
    const u64 deg = j * (k - j);
    if (off >= hi) break;  // offsets increase with j
    if (off + deg < lo) continue;
    qbinom_coeffs(k, j, N, qb);
    const u64 d0 = (lo > off) ? lo - off : 0;
    const u64 d1 = (off + deg + 1 < hi ? off + deg + 1 : hi) - off;
    if (j & 1) {
      for (u64 d = d0; d < d1; ++d)
        out[off + d - lo] = submod(out[off + d - lo], qb[d], N);
    } else {
      for (u64 d = d0; d < d1; ++d)
        out[off + d - lo] = addmod(out[off + d - lo], qb[d], N);
    }
  }
  std::free(qb);
  return 0;
}

}  // extern "C"
