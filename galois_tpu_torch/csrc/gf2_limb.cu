// Kernel K14: GF(2^m) products, squares and powers for 32 < m <= 576 on the
// port's planar limb storage (fields/_meta.py): L = ceil(m / 16)
// little-endian uint16 limbs of the m coefficient bits, limb k of element e at
// a[k * plane + e * es] (plane: the operand's plane stride; es: 1, or 0 for a
// one-element operand read by every thread). Wrappers and plain torch
// versions: ops/_limb_binary.py.
//
// It replaces the lax.scan products of the JAX package's LimbBinaryOps
// (multiply_t, square_t and _reduce_t, galois_tpu/ops/_kernels.py:1345-1416):
// there a product is a scan over the m bits of b on ceil((2m - 1) / 16) limb
// planes, then a scan over the m - 1 reduction bits; in eager torch that
// would be thousands of launches a product, and a reciprocal's ladder over a
// million. No Pallas kernel computes these maps.
//
// Design: one thread an element. It packs its L limbs into W = ceil(m / 64)
// 64-bit words (W a template parameter, 1..9, so that every word index is
// static and the words live in registers), computes in registers and writes
// the L limbs back. The product runs b's bits from the top, interleaving the
// reduction: r = r x mod f (a one-bit shift of W words; the bit that leaves
// x^(m-1) folds back as f - x^m), then r ^= a where the bit of b is set.
// That is m steps of about 6W 64-bit operations, for any f, dense or sparse,
// with no 2m-bit intermediate. The square entry is the product with a = b.
// The power entry runs a left-to-right square-and-multiply ladder in
// registers, one launch a call: for a public exponent (passed by value, up
// to 640 bits; the reciprocal a^(2^m - 2) and the square root a^(2^(m-1))
// among them), or for per-element exponents of 62-bit int64 words (the
// exponent-array power), read by stride.
//
// What bounds it on the H100: the integer ALUs. A GF(2^128) product moves 48
// bytes but costs about 128 steps of some 32 32-bit operations; its byte
// bound at 2^24 elements is 0.24 ms, its operation count several times
// that (chip_smoke.py prints both). A windowed (comb) product or a
// word-level Karatsuba would cut the operations; the form here is the
// simple one that is right.

#include <cuda_runtime.h>
#include <stdint.h>

// A modulus or public exponent as 64-bit words, passed by value; outside the
// anonymous namespace, so that the extern "C" entry points keep external linkage.
struct Gf2LimbWords {
  unsigned long long w[10];
};

namespace {

constexpr int THREADS = 256;
constexpr int EXP_WORDS = 10;
using Words = Gf2LimbWords;

template <int W>
__device__ __forceinline__ void load(const uint16_t* __restrict__ a, long long plane, long long idx, int L,
                                     unsigned long long (&x)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    unsigned long long v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = 4 * k + j;
      if (l < L) v |= static_cast<unsigned long long>(__ldg(a + l * plane + idx)) << (16 * j);
    }
    x[k] = v;
  }
}

template <int W>
__device__ __forceinline__ void store(uint16_t* __restrict__ out, long long n, long long e, int L,
                                      const unsigned long long (&x)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = 4 * k + j;
      if (l < L) out[l * n + e] = static_cast<uint16_t>(x[k] >> (16 * j));
    }
  }
}

// r = a * b mod f, all below 2^m; fr = f - x^m; top = m - 64 (W - 1) bits in the top word.
template <int W>
__device__ __forceinline__ void mulmod(const unsigned long long (&a)[W], const unsigned long long (&b)[W],
                                       unsigned long long (&r)[W], const Words& fr, int top) {
  const unsigned long long top_mask = top == 64 ? ~0ull : ((1ull << top) - 1);
  unsigned long long t[W];
#pragma unroll
  for (int k = 0; k < W; ++k) t[k] = 0;
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    const unsigned long long bw = b[w];
    const int nb = w == W - 1 ? top : 64;
#pragma unroll 4
    for (int s = nb - 1; s >= 0; --s) {
      const unsigned long long carry = 0ull - ((t[W - 1] >> (top - 1)) & 1ull);
#pragma unroll
      for (int k = W - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 63);
      t[0] <<= 1;
      t[W - 1] &= top_mask;
      const unsigned long long bit = 0ull - ((bw >> s) & 1ull);
#pragma unroll
      for (int k = 0; k < W; ++k) t[k] ^= (fr.w[k] & carry) ^ (a[k] & bit);
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = t[k];
}

template <int W>
__global__ void __launch_bounds__(THREADS) mul_kernel(const uint16_t* __restrict__ a, long long ap, long long ae,
                                                      const uint16_t* __restrict__ b, long long bp, long long be,
                                                      uint16_t* __restrict__ out, long long n, int L, int top,
                                                      Words fr) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n) return;
  unsigned long long x[W], y[W], r[W];
  load<W>(a, ap, e * ae, L, x);
  load<W>(b, bp, e * be, L, y);
  mulmod<W>(x, y, r, fr, top);
  store<W>(out, n, e, L, r);
}

template <int W>
__global__ void __launch_bounds__(THREADS) pow_kernel(const uint16_t* __restrict__ a, long long ap, long long ae,
                                                      uint16_t* __restrict__ out, long long n, int L, int top,
                                                      Words fr, Words ex, int nbits,
                                                      const long long* __restrict__ ew, long long ews,
                                                      long long ees) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n) return;
  unsigned long long x[W], r[W];
  load<W>(a, ap, e * ae, L, x);
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = k == 0 ? 1ull : 0ull;
  for (int i = nbits - 1; i >= 0; --i) {
    mulmod<W>(r, r, r, fr, top);
    const bool bit = ew ? ((__ldg(ew + (i / 62) * ews + e * ees) >> (i % 62)) & 1) : ((ex.w[i / 64] >> (i % 64)) & 1);
    if (bit) mulmod<W>(r, x, r, fr, top);
  }
  store<W>(out, n, e, L, r);
}

bool valid(long long n, int m) { return n > 0 && m > 32 && m <= 64 * 9; }

dim3 grid_for(long long n) { return dim3(static_cast<unsigned>((n + THREADS - 1) / THREADS)); }

}  // namespace

// out (L, n) = a * b over GF(2^m); a and b planar uint16 limbs read at
// a[k * ap + e * ae]; fr = f - x^m as 64-bit words.
extern "C" int gf2_limb_mul_launch(const uint16_t* a, long long ap, long long ae, const uint16_t* b, long long bp,
                                   long long be, uint16_t* out, long long n, int m, Gf2LimbWords fr, void* stream) {
  if (!valid(n, m)) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (m + 63) / 64, L = (m + 15) / 16, top = m - 64 * (W - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MUL_CASE(K) \
  case K: mul_kernel<K><<<grid_for(n), THREADS, 0, s>>>(a, ap, ae, b, bp, be, out, n, L, top, fr); break;
  switch (W) {
    MUL_CASE(1) MUL_CASE(2) MUL_CASE(3) MUL_CASE(4) MUL_CASE(5) MUL_CASE(6) MUL_CASE(7) MUL_CASE(8) MUL_CASE(9)
  }
#undef MUL_CASE
  return static_cast<int>(cudaGetLastError());
}

// out (L, n) = a^e over GF(2^m): per_element == 0 takes the public exponent
// ex (nbits bits); otherwise bit i of element e's exponent is bit i % 62 of
// ew[(i / 62) * ews + e * ees].
extern "C" int gf2_limb_pow_launch(const uint16_t* a, long long ap, long long ae, uint16_t* out, long long n, int m,
                                   Gf2LimbWords fr, Gf2LimbWords ex, int nbits, const long long* ew, long long ews,
                                   long long ees, int per_element, void* stream) {
  if (!valid(n, m) || nbits < 0 || (!per_element && nbits > 64 * EXP_WORDS) || (per_element && !ew)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = (m + 63) / 64, L = (m + 15) / 16, top = m - 64 * (W - 1);
  const long long* words = per_element ? ew : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POW_CASE(K)                                                                                \
  case K:                                                                                          \
    pow_kernel<K><<<grid_for(n), THREADS, 0, s>>>(a, ap, ae, out, n, L, top, fr, ex, nbits, words, ews, ees); \
    break;
  switch (W) {
    POW_CASE(1) POW_CASE(2) POW_CASE(3) POW_CASE(4) POW_CASE(5) POW_CASE(6) POW_CASE(7) POW_CASE(8) POW_CASE(9)
  }
#undef POW_CASE
  return static_cast<int>(cudaGetLastError());
}
