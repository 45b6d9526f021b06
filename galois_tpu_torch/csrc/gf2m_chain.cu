// Kernels K8-A and K8-B: K8's SWAR product core (gf2m_swar.cuh) held in
// registers across whole chains of GF(2^m) products, where K8 alone made one
// HBM round trip per product.
//
// K8-A, gf2m_power: out = a^e elementwise in GF(2^m), 2 <= m <= 16, in the
// field's storage dtype (uint8 for m <= 8, int64 above). Wrapper and plain
// torch version: ops/_elementwise.py::gf2m_power. The exponent is either
//   - the compile-time Itoh-Tsujii chain for a^(2^m - 2), the reciprocal
//     (0 at a = 0, as the plain chain gives): t = a^(2^k - 1) grows along the
//     bits of m - 1, then one square; 7 squares and 4 products at m = 8; or
//   - a per-element int64 exponent tensor, read through (row, column) element
//     strides so that a broadcast operand is not materialized. Only the low
//     nbits bits count, as in the plain ladder over nbits bits; each exponent
//     is reduced to e' in [0, 2^m - 1] (e' = 0 only where those bits are 0,
//     else e' = (e - 1) mod (2^m - 1) + 1, so 0^0 = 1, 0^e = 0 and
//     a^e = a^e' for a != 0), and the ladder runs over e''s m bits.
// It replaces the torch chains of ops/_kernels.py BinaryExtOps.reciprocal,
// power and power_static (each square some 30 torch passes, each product a
// K8 or K7 launch). The JAX references are BinaryExtOps.reciprocal and
// FieldOps.power of galois_tpu/ops/_kernels.py; no Pallas kernel computes
// these chains (XLA fused them on the TPU).
// Design: for m <= 8 each thread takes 16 elements, four per u32 word (one
// 16-byte load when a is contiguous and aligned, byte loads by stride else),
// and runs the whole chain on its 4 independent words in registers: products
// are K8's mul_core<M>, squares the bit-spread form (bytes spread to 16-bit
// slots, then K8's fold), the ladder's selects byte masks. For 9 <= m <= 16
// each thread takes 4 elements, one per 32-bit lane: an m-step shift-AND-XOR
// ladder for products, a 4-step bit spread for squares, then folds by
// r = f ^ x^m. What bounds it: the integer ALUs. At m = 8, f = 0x11D, a
// product costs about 155 32-bit operations per word of four elements and a
// square about 71, so the reciprocal is about 1117 per word against 2 bytes
// moved per element: some 4.7e9 operations at 2^24 elements (0.28 ms at the
// int32 rate of 132 SMs x 64 lanes x 1.98 GHz) against 0.010 ms of HBM.
//
// K8-B, berlekamp_massey_scan: the whole masked Berlekamp-Massey scan of the
// batched RS/BCH decoder in one launch, for 2 <= m <= 8 with d - 1 <= 64
// and for 9 <= m <= 16 with d - 1 <= 32. Wrapper and plain torch version:
// ops/_bm_scan.py. It computes exactly what berlekamp_massey_scan_plain (the
// decoder's loop) computes: with the per-row erasure offset u, step t is a
// no-op while t < u, "grow" compares 2 L against t - u, the B register is
// not shifted on inactive rows, and C changes only where delta != 0. In: S'
// (B, d - 1) and u (B,) int64; out: C (B, d) and L (B,) int64; S' and C in
// the field's storage (uint8 for m <= 8, int64 above). The JAX reference is
// the jitted lax.scan berlekamp_massey of galois_tpu/codes/_decoder.py.
// Design: one codeword per thread. 65536 rows give some 500 threads per SM,
// so the parallelism inside a row has to come from its words: C, B and the
// reversed syndrome window W[i] = S'[t - i] live in register arrays whose
// loops over words are unrolled with static indices (m <= 8: NW words of
// four bytes, the words of d elements rounded up to 2, 4, 9 or 17; above:
// ND elements, one per 32-bit lane, d rounded up to 5, 9, 17 or 33). Lanes
// per codeword (with __shfl_xor_sync for the dot) would need shuffles for
// the window and B shifts that cross words at every step, for no fewer
// operations. The block first stages the field's tables in shared memory,
// in ops/_lookup.py::pack_tables' layout from the field's own EXP and LOG:
// for m <= 8 the 2(q - 1) int32 byte rows (2 KB at q = 256), for m <= 14
// the uint16 LOG and reduced EXP (64 KB at 2^14), for m = 15, 16 the INV
// segment alone (128 KB at 2^16). Per step t:
//   - the window shifts up one element and takes S'[t] into element 0;
//   - delta = sum_i C[i] S'[t - i]: the carry-less products (m <= 8: K8's
//     nibble Karatsuba in byte slots; above: the one-lane ladder) are
//     XOR-summed unreduced, then reduced once (the reduction is linear, so
//     this equals summing reduced products): for m <= 8 each bit m + j of
//     the sum selects x^(m + j) mod f from a table in registers, above by
//     reduce1's folds;
//   - coef = delta / bb without a reciprocal chain: each row keeps
//     kb = (q - 1) - LOG[bb] in a register, taken from the row of delta just
//     read whenever the row grows (bb = delta), so coef = EXP[LOG delta + kb]
//     is two dependent shared-memory reads (the byte rows' EXP is doubled;
//     the uint16 EXP takes one conditional subtract). With INV staged alone
//     the register holds INV[bb] and coef is one scalar product;
//   - C' = C + (x B) coef: the multiply by the row's constant coef is a
//     table of coef x^i (i < m), selected by the bits of each element of
//     x B; no reduction is needed. For m <= 8 the table is m independent
//     reads EXP[LOG coef + LOG x^i], each replicated into the four bytes by
//     one byte permute; above m = 8 it is built from coef by m dependent
//     shift steps;
//   - the selects are per-row predicates.
// At step t only elements 0..t + 1 of C and B, and 0..t of the window, can be
// nonzero (degrees grow by at most one a step), so the words above them are
// skipped; the test is uniform across the warp. S' is read once (loads
// through L1, each a step ahead of its use), C and L written once. What
// bounds it: the integer ALUs; RS(255,223) at B = 65536 is about 0.9e9
// operations (0.054 ms at the int32 rate of 132 SMs x 64 lanes x 1.98 GHz;
// 1.8e9 with a reciprocal chain in the step) against 4.8 MB of HBM traffic
// (0.0014 ms) and some 0.6 M shared-memory wavefronts (0.002 ms). With some
// 4 warps a scheduler and a step chain of a few dozen dependent operations
// and three dependent table reads, about two thirds of the operations bound
// is reached.
//
// Both entry points return cudaGetLastError() after their launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gf2m_swar.cuh"

namespace {

constexpr int THREADS = 256;     // K8-A
constexpr int SCALAR_ELEMS = 4;  // K8-A, 9 <= m <= 16: elements per thread
constexpr int BM_THREADS = 64;   // K8-B, m <= 8: 1024 blocks for 65536 rows, about 8 per SM
constexpr int BM_BLOCKS_PER_SM = 8;  // so up to 128 registers a thread: no spills at 17 words
constexpr int BM_WIDE_THREADS = 128;  // K8-B, 9 <= m <= 16: up to 3 x 33 elements in registers

__host__ __device__ constexpr int top_bit(int x) { return x < 2 ? 0 : 1 + top_bit(x >> 1); }

// ---- one element per 32-bit lane, m <= 16 ----

// Carry-less a * b of M-bit values: the shift-AND-XOR ladder over b's bits.
template <int M>
__device__ __forceinline__ uint32_t clmul1(uint32_t a, uint32_t b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) acc ^= (a << i) & (0u - ((b >> i) & 1u));
  return acc;
}

// A (2M - 1)-bit value mod f: constant folds by r = f ^ x^M (x^M = r mod f).
template <int M>
__device__ __forceinline__ uint32_t reduce1(uint32_t c, uint32_t r, int deg_r) {
  int width = 2 * M - 1;
  while (width > M) {  // the same trip count in every thread
    const uint32_t h = c >> M;
    uint32_t t = 0;
    for (uint32_t j = r; j; j &= j - 1) t ^= h << (__ffs(j) - 1);
    c = (c & ((1u << M) - 1)) ^ t;
    width = max(M, width - M + deg_r);
  }
  return c;
}

// Bit i of a 16-bit value to bit 2i: the carry-less square before reduction.
__device__ __forceinline__ uint32_t spread16(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

template <int M>
struct One {  // one element in a lane
  uint32_t x;
};

template <int M>
struct Four {  // 16 elements of M <= 8 bits, four per word
  uint32_t w[4];
};

template <int M>
__device__ __forceinline__ One<M> mul(One<M> a, One<M> b, uint32_t r, int deg_r) {
  return {reduce1<M>(clmul1<M>(a.x, b.x), r, deg_r)};
}

template <int M>
__device__ __forceinline__ One<M> sqr(One<M> a, uint32_t r, int deg_r) {
  return {reduce1<M>(spread16(a.x), r, deg_r)};
}

template <int M>
__device__ __forceinline__ Four<M> mul(Four<M> a, const Four<M>& b, uint32_t r, int deg_r) {
  mul_core<M>(a.w, b.w, r, deg_r);
  return a;
}

// Squares in byte slots: each value's bits spread to twice their place, in
// byte slots for M <= 4 (7-bit results) and in 16-bit slots of the even and
// the odd bytes above (as mul_core's products), then K8's folds.
template <int M>
__device__ __forceinline__ Four<M> sqr(Four<M> a, uint32_t r, int deg_r) {
  if constexpr (M <= 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t x = a.w[k];
      x = (x | (x << 2)) & 0x33333333u;
      a.w[k] = (x | (x << 1)) & 0x55555555u;
    }
    fold<M, 8, 4>(a.w, r, deg_r);
  } else {
    uint32_t p[8];  // p[0..3]: the even bytes' squares, p[4..7]: the odd bytes'
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t x = (k < 4 ? a.w[k] : a.w[k - 4] >> 8) & EVEN;
      x = (x | (x << 4)) & 0x0F0F0F0Fu;
      x = (x | (x << 2)) & 0x33333333u;
      p[k] = (x | (x << 1)) & 0x55555555u;
    }
    fold<M, 16, 8>(p, r, deg_r);
#pragma unroll
    for (int k = 0; k < 4; ++k) a.w[k] = p[k] | (p[k + 4] << 8);
  }
  return a;
}

// a^(2^M - 2) by Itoh-Tsujii: t = a^(2^k - 1) along the bits of M - 1
// below the top one (k -> 2k: t^(2^k) t; k -> k + 1: t^2 a), then t^2.
template <int M, class V>
__device__ __forceinline__ V inverse(const V& a, uint32_t r, int deg_r) {
  V t = a;
  int k = 1;
#pragma unroll
  for (int bit = top_bit(M - 1) - 1; bit >= 0; --bit) {
    V tk = t;
#pragma unroll
    for (int s = 0; s < k; ++s) tk = sqr(tk, r, deg_r);
    t = mul(tk, t, r, deg_r);
    k *= 2;
    if (((M - 1) >> bit) & 1) {
      t = mul(sqr(t, r, deg_r), a, r, deg_r);
      k += 1;
    }
  }
  return sqr(t, r, deg_r);
}

// The exponent's low nbits bits, reduced to e' in [0, 2^M - 1] with the same
// power for every a (see the head).
template <int M>
__device__ __forceinline__ uint32_t reduce_exponent(long long e, int nbits) {
  unsigned long long v = static_cast<unsigned long long>(e);
  if (nbits < 64) v &= (1ull << nbits) - 1;
  constexpr unsigned long long Q1 = (1ull << M) - 1;
  return v == 0 ? 0u : static_cast<uint32_t>((v - 1) % Q1 + 1);
}

// a^e, e < 2^M: the binary ladder over e's M bits, every product computed
// and selected (no divergence).
template <int M>
__device__ __forceinline__ One<M> power(One<M> a, uint32_t e, uint32_t r, int deg_r) {
  One<M> result{1u}, base = a;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const One<M> prod = mul(result, base, r, deg_r);
    result.x = ((e >> i) & 1u) ? prod.x : result.x;
    if (i + 1 < M) base = sqr(base, r, deg_r);
  }
  return result;
}

// The same ladder on four words; e holds the 16 exponents in the elements'
// byte slots, and bit i of each byte widens to a byte mask.
template <int M>
__device__ __forceinline__ Four<M> power(const Four<M>& a, const uint32_t (&e)[4], uint32_t r, int deg_r) {
  Four<M> result, base = a;
#pragma unroll
  for (int k = 0; k < 4; ++k) result.w[k] = ONES;  // 1 in every byte
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const Four<M> prod = mul(result, base, r, deg_r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t bit = (e[k] >> i) & ONES;
      const uint32_t mask = (bit << 8) - bit;
      result.w[k] = (prod.w[k] & mask) | (result.w[k] & ~mask);
    }
    if (i + 1 < M) base = sqr(base, r, deg_r);
  }
  return result;
}

// ---- K8-A ----

// m <= 8: one thread per 16-element chunk of the (rows, cols) output; a and
// e are read at row * rs + col * cs (element strides). Chunks below nvec
// (a contiguous, a and out 16-byte aligned) take 16-byte loads of a and
// 16-byte stores, the rest byte accesses.
template <int M, bool POW>
__global__ void __launch_bounds__(THREADS)
power_packed_kernel(const uint8_t* __restrict__ a, long long a_rs, long long a_cs,
                    const long long* __restrict__ e, long long e_rs, long long e_cs, int nbits,
                    uint8_t* __restrict__ out, long long n, long long cols, long long nvec,
                    uint32_t r, int deg_r) {
  const long long chunk = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long base = chunk * 16;
  if (base >= n) return;
  const bool vec = chunk < nvec;
  Four<M> A;
  uint32_t E[4] = {0u, 0u, 0u, 0u};
  if (vec) {
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + chunk);
    A.w[0] = va.x, A.w[1] = va.y, A.w[2] = va.z, A.w[3] = va.w;
  }
  if (!vec || POW) {
    long long row = base / cols, col = base - row * cols;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!vec) A.w[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base + 4 * k + j < n) {
          if (!vec) A.w[k] |= static_cast<uint32_t>(a[row * a_rs + col * a_cs]) << (8 * j);
          if constexpr (POW) E[k] |= reduce_exponent<M>(__ldg(e + row * e_rs + col * e_cs), nbits) << (8 * j);
        }
        if (++col == cols) col = 0, ++row;
      }
    }
  }
  Four<M> R;
  if constexpr (POW) {
    R = power<M>(A, E, r, deg_r);
  } else {
    R = inverse<M>(A, r, deg_r);
  }
  if (vec) {
    reinterpret_cast<uint4*>(out)[chunk] = make_uint4(R.w[0], R.w[1], R.w[2], R.w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + 4 * k + j;
        if (i < n) out[i] = static_cast<uint8_t>(R.w[k] >> (8 * j));
      }
    }
  }
}

// 9 <= m <= 16, int64 storage: SCALAR_ELEMS elements a thread, THREADS
// apart (coalesced), each its own chain in a 32-bit lane.
template <int M, bool POW>
__global__ void __launch_bounds__(THREADS)
power_scalar_kernel(const long long* __restrict__ a, long long a_rs, long long a_cs,
                    const long long* __restrict__ e, long long e_rs, long long e_cs, int nbits,
                    long long* __restrict__ out, long long n, long long cols, uint32_t r, int deg_r) {
  const long long first = static_cast<long long>(blockIdx.x) * (THREADS * SCALAR_ELEMS) + threadIdx.x;
  One<M> x[SCALAR_ELEMS];
  uint32_t ex[SCALAR_ELEMS];
#pragma unroll
  for (int s = 0; s < SCALAR_ELEMS; ++s) {
    const long long i = first + s * THREADS;
    x[s].x = 0, ex[s] = 0;
    if (i < n) {
      const long long row = i / cols, col = i - row * cols;
      x[s].x = static_cast<uint32_t>(__ldg(a + row * a_rs + col * a_cs));
      if constexpr (POW) ex[s] = reduce_exponent<M>(__ldg(e + row * e_rs + col * e_cs), nbits);
    }
  }
#pragma unroll
  for (int s = 0; s < SCALAR_ELEMS; ++s) {
    if constexpr (POW) {
      x[s] = power<M>(x[s], ex[s], r, deg_r);
    } else {
      x[s] = inverse<M>(x[s], r, deg_r);
    }
  }
#pragma unroll
  for (int s = 0; s < SCALAR_ELEMS; ++s) {
    const long long i = first + s * THREADS;
    if (i < n) out[i] = x[s].x;
  }
}

// ---- K8-B ----

// XOR-accumulate the unreduced byte-slot products of the words x and y:
// for M <= 4 one ladder (7-bit slot products), above it K8's nibble
// Karatsuba pieces lo*lo, hi*hi and (lo^hi)*(lo^hi), each summed apart.
template <int M>
__device__ __forceinline__ void clmul_acc(uint32_t x, uint32_t y, uint32_t& ll, uint32_t& hh, uint32_t& mm) {
  if constexpr (M <= 4) {
    ll ^= nib_ladder<M>(x, y);
  } else {
    const uint32_t xl = x & NIB, xh = (x >> 4) & NIB, yl = y & NIB, yh = (y >> 4) & NIB;
    ll ^= nib_ladder<4>(xl, yl);
    hh ^= nib_ladder<M - 4>(xh, yh);
    mm ^= nib_ladder<4>(xl ^ xh, yl ^ yh);
  }
}

__device__ __forceinline__ uint32_t xor_bytes(uint32_t x) {
  x ^= x >> 16;
  return (x ^ (x >> 8)) & 0xFFu;
}

// The carry-less sum of all the accumulated products, 2M - 1 bits.
template <int M>
__device__ __forceinline__ uint32_t clmul_sum(uint32_t ll, uint32_t hh, uint32_t mm) {
  if constexpr (M <= 4) {
    return xor_bytes(ll);
  } else {
    const uint32_t l = xor_bytes(ll), h = xor_bytes(hh), mid = xor_bytes(mm) ^ l ^ h;
    return l ^ (mid << 4) ^ (h << 8);
  }
}

// cx[i] = c x^i mod f, i < N, f of degree M: the table of a multiply by c,
// by N dependent steps.
template <int M, int N = M>
__device__ __forceinline__ void const_table(uint32_t c, uint32_t f, uint32_t (&cx)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cx[i] = c;
    c <<= 1;
    c ^= f & (0u - (c >> M));
  }
}

// x * c in byte slots for the c of the table: bit i of each byte selects cx[i].
template <int M>
__device__ __forceinline__ uint32_t mul_const(uint32_t x, const uint32_t (&cx)[M]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const uint32_t bit = (x >> i) & ONES;
    acc ^= cx[i] & ((bit << 8) - bit);
  }
  return acc;
}

// x * c for one element in a lane: bit i of x selects cx[i], i < N.
template <int N>
__device__ __forceinline__ uint32_t mul_const1(uint32_t x, const uint32_t (&cx)[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc ^= cx[i] & (0u - ((x >> i) & 1u));
  return acc;
}

// m <= 8, one thread per codeword: element i of C, B and the window in byte
// i % 4 of word i / 4. T is pack_tables' 'bytes' layout, 2(q - 1) words:
// byte 0 LOG[r], byte 1 EXP[r] (doubled), byte 2 (q - 1) - LOG[r]. The
// multiply table by coef is m independent EXP reads.
template <int M, int NW>
__global__ void __launch_bounds__(BM_THREADS, BM_BLOCKS_PER_SM)
bm_scan_kernel(const uint8_t* __restrict__ sp, const long long* __restrict__ u_in, const uint32_t* __restrict__ tab,
               uint8_t* __restrict__ c_out, long long* __restrict__ l_out, long long rows, int d, uint32_t r) {
  constexpr uint32_t Q1 = (1u << M) - 1;
  __shared__ uint32_t T[2 * Q1];
  for (int i = threadIdx.x; i < static_cast<int>(2 * Q1); i += BM_THREADS) T[i] = __ldg(tab + i);
  __syncthreads();
  const long long row = static_cast<long long>(blockIdx.x) * BM_THREADS + threadIdx.x;
  if (row >= rows) return;
  const int steps = d - 1;
  const uint8_t* s = sp + row * steps;
  const long long u = __ldg(u_in + row);
  uint32_t C[NW], Bp[NW], W[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) C[k] = 0, Bp[k] = 0, W[k] = 0;
  C[0] = 1, Bp[0] = 1;
  uint32_t lx[M];  // LOG[x^i]: x^i is the element 1 << i for i < m
#pragma unroll
  for (int i = 0; i < M; ++i) lx[i] = T[1u << i] & 0xFFu;
  uint32_t xr[M - 1];  // x^(m + j) mod f: the reduction is linear in the bits above m
  const_table<M, M - 1>(r, r ^ (1u << M), xr);
  uint32_t nlb = Q1;  // (q - 1) - LOG[bb], bb = 1 at the start
  long long L = 0;
  uint32_t next = __ldg(s);  // S'[t + 1] is loaded during step t, off the critical path
  for (int t = 0; t < steps; ++t) {
    const uint32_t s_t = next;
    if (t + 1 < steps) next = __ldg(s + t + 1);
    // the window W[i] = S'[t - i]: up one element, S'[t] into element 0
#pragma unroll
    for (int k = NW - 1; k > 0; --k) {
      if (4 * k <= t) W[k] = __funnelshift_l(W[k - 1], W[k], 8);
    }
    W[0] = (W[0] << 8) | s_t;
    // delta = sum over i <= t of C[i] S'[t - i]
    uint32_t ll = 0, hh = 0, mm = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (4 * k <= t) clmul_acc<M>(C[k], W[k], ll, hh, mm);
    }
    const uint32_t sum = clmul_sum<M>(ll, hh, mm);
    const uint32_t delta = (sum & Q1) ^ mul_const1<M - 1>(sum >> M, xr);
    // coef = delta / bb = EXP[LOG delta + (q - 1) - LOG bb], and the table
    // cx[i] = coef x^i = EXP[LOG coef + LOG x^i]: at delta = 0 it is not 0,
    // but C keeps its value there (upd below)
    const uint32_t w = T[delta];
    uint32_t lc = (w & 0xFFu) + nlb;  // < 2(q - 1)
    lc = lc >= Q1 ? lc - Q1 : lc;      // LOG coef
    uint32_t cx[M];
#pragma unroll
    for (int i = 0; i < M; ++i) cx[i] = __byte_perm(T[lc + lx[i]], 0, 0x1111);  // byte 1 into all four
    const bool active = t >= u;  // rows with more erasures start later
    const bool upd = active && delta != 0;
    const bool grow = upd && 2 * L <= t - u;
    // C' = C + (x B) coef; B <- C where the row grows, x B where it is active;
    // downwards, so that word k - 1 of B is still the old one
#pragma unroll
    for (int k = NW - 1; k >= 0; --k) {
      if (4 * k <= t + 1) {
        const uint32_t xb = k ? __funnelshift_l(Bp[k - 1], Bp[k], 8) : Bp[0] << 8;
        const uint32_t c_new = C[k] ^ mul_const<M>(xb, cx);
        if (active) Bp[k] = grow ? C[k] : xb;
        if (upd) C[k] = c_new;
      }
    }
    if (grow) nlb = (w >> 16) & 0xFFu, L = t - u + 1 - L;  // bb = delta
  }
  uint8_t* c = c_out + row * d;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * k + j < d) c[4 * k + j] = static_cast<uint8_t>(C[k] >> (8 * j));
    }
  }
  l_out[row] = L;
}

// 9 <= m <= 16, int64 storage, one thread per codeword and one element of
// C, B and the window per 32-bit lane (ND >= d of each). The table is
// pack_tables' uint16 layout (LOG at [0, q), the reduced EXP at [q, 2q - 1),
// INV at [2q, 3q)); the block stages LOG and EXP (m <= 14, at most 64 KB),
// or INV alone for INV_FORM (m = 15, 16: LOG alone would be 128 KB at
// 2^16), where coef = delta * INV[bb] is one scalar product.
template <int M, int ND, bool INV_FORM>
__global__ void __launch_bounds__(BM_WIDE_THREADS)
bm_scan_wide_kernel(const long long* __restrict__ sp, const long long* __restrict__ u_in,
                    const uint16_t* __restrict__ tab, long long* __restrict__ c_out, long long* __restrict__ l_out,
                    long long rows, int d, uint32_t f, uint32_t r, int deg_r) {
  constexpr uint32_t Q = 1u << M, Q1 = Q - 1;
  constexpr int STAGED = INV_FORM ? Q : 2 * Q;  // uint16 entries
  extern __shared__ uint4 smem[];
  {
    const uint4* src = reinterpret_cast<const uint4*>(tab + (INV_FORM ? 2 * Q : 0));
    for (int i = threadIdx.x; i < STAGED / 8; i += BM_WIDE_THREADS) smem[i] = __ldg(src + i);
  }
  __syncthreads();
  const uint16_t* T = reinterpret_cast<const uint16_t*>(smem);
  const long long row = static_cast<long long>(blockIdx.x) * BM_WIDE_THREADS + threadIdx.x;
  if (row >= rows) return;
  const int steps = d - 1;
  const long long* s = sp + row * steps;
  const long long u = __ldg(u_in + row);
  uint32_t C[ND], Bp[ND], W[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) C[k] = 0, Bp[k] = 0, W[k] = 0;
  C[0] = 1, Bp[0] = 1;
  uint32_t kb = INV_FORM ? 1u : Q1;  // bb's key: INV[bb], or (q - 1) - LOG[bb]; bb = 1 at the start
  long long L = 0;
  uint32_t next = static_cast<uint32_t>(__ldg(s));
  for (int t = 0; t < steps; ++t) {
    const uint32_t s_t = next;
    if (t + 1 < steps) next = static_cast<uint32_t>(__ldg(s + t + 1));
#pragma unroll
    for (int k = ND - 1; k > 0; --k) {
      if (k <= t) W[k] = W[k - 1];
    }
    W[0] = s_t;
    // delta: the XOR-sum of the unreduced products, reduced once
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      if (k <= t) acc ^= clmul1<M>(C[k], W[k]);
    }
    const uint32_t delta = reduce1<M>(acc, r, deg_r);
    uint32_t coef, grown;  // grown: kb's value if the row grows (bb = delta)
    if constexpr (INV_FORM) {
      coef = reduce1<M>(clmul1<M>(delta, kb), r, deg_r);
      grown = T[delta];
    } else {
      const uint32_t lg = T[delta];
      uint32_t sc = lg + kb;
      sc = sc >= Q1 ? sc - Q1 : sc;
      coef = T[Q + sc];
      grown = Q1 - lg;
    }
    uint32_t cx[M];
    const_table<M>(coef, f, cx);
    const bool active = t >= u;
    const bool upd = active && delta != 0;
    const bool grow = upd && 2 * L <= t - u;
#pragma unroll
    for (int k = ND - 1; k >= 0; --k) {
      if (k <= t + 1) {
        const uint32_t xb = k ? Bp[k - 1] : 0u;
        const uint32_t c_new = C[k] ^ mul_const1<M>(xb, cx);
        if (active) Bp[k] = grow ? C[k] : xb;
        if (upd) C[k] = c_new;
      }
    }
    if (grow) kb = grown, L = t - u + 1 - L;
  }
  long long* c = c_out + row * d;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    if (k < d) c[k] = C[k];
  }
  l_out[row] = L;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int M>
void launch_power(dim3 grid, cudaStream_t s, const void* a, long long a_rs, long long a_cs, const long long* e,
                  long long e_rs, long long e_cs, int nbits, void* out, long long n, long long cols, long long nvec,
                  uint32_t r, int deg_r) {
  if constexpr (M <= 8) {
    const auto* a8 = static_cast<const uint8_t*>(a);
    auto* o8 = static_cast<uint8_t*>(out);
    if (e) {
      power_packed_kernel<M, true><<<grid, THREADS, 0, s>>>(a8, a_rs, a_cs, e, e_rs, e_cs, nbits, o8, n, cols, nvec, r, deg_r);
    } else {
      power_packed_kernel<M, false><<<grid, THREADS, 0, s>>>(a8, a_rs, a_cs, e, e_rs, e_cs, nbits, o8, n, cols, nvec, r, deg_r);
    }
  } else {
    const auto* a64 = static_cast<const long long*>(a);
    auto* o64 = static_cast<long long*>(out);
    if (e) {
      power_scalar_kernel<M, true><<<grid, THREADS, 0, s>>>(a64, a_rs, a_cs, e, e_rs, e_cs, nbits, o64, n, cols, r, deg_r);
    } else {
      power_scalar_kernel<M, false><<<grid, THREADS, 0, s>>>(a64, a_rs, a_cs, e, e_rs, e_cs, nbits, o64, n, cols, r, deg_r);
    }
  }
}

template <int M>
void launch_bm(int nw, dim3 grid, cudaStream_t s, const uint8_t* sp, const long long* u, const uint32_t* tab,
               uint8_t* c, long long* l, long long rows, int d, uint32_t r) {
  if (nw <= 2) {
    bm_scan_kernel<M, 2><<<grid, BM_THREADS, 0, s>>>(sp, u, tab, c, l, rows, d, r);
  } else if (nw <= 4) {
    bm_scan_kernel<M, 4><<<grid, BM_THREADS, 0, s>>>(sp, u, tab, c, l, rows, d, r);
  } else if (nw <= 9) {
    bm_scan_kernel<M, 9><<<grid, BM_THREADS, 0, s>>>(sp, u, tab, c, l, rows, d, r);
  } else {
    bm_scan_kernel<M, 17><<<grid, BM_THREADS, 0, s>>>(sp, u, tab, c, l, rows, d, r);
  }
}

template <int M, int ND>
cudaError_t launch_wide_nd(dim3 grid, cudaStream_t s, const long long* sp, const long long* u, const uint16_t* tab,
                           long long* c, long long* l, long long rows, int d, uint32_t f, uint32_t r, int deg_r) {
  constexpr bool INV_FORM = M > 14;
  constexpr int smem = (INV_FORM ? 1 : 2) * (1 << M) * static_cast<int>(sizeof(uint16_t));
  auto kernel = bm_scan_wide_kernel<M, ND, INV_FORM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, BM_WIDE_THREADS, smem, s>>>(sp, u, tab, c, l, rows, d, f, r, deg_r);
  return cudaSuccess;
}

template <int M>
cudaError_t launch_wide(dim3 grid, cudaStream_t s, const long long* sp, const long long* u, const uint16_t* tab,
                        long long* c, long long* l, long long rows, int d, uint32_t f, uint32_t r, int deg_r) {
  if (d <= 5) return launch_wide_nd<M, 5>(grid, s, sp, u, tab, c, l, rows, d, f, r, deg_r);
  if (d <= 9) return launch_wide_nd<M, 9>(grid, s, sp, u, tab, c, l, rows, d, f, r, deg_r);
  if (d <= 17) return launch_wide_nd<M, 17>(grid, s, sp, u, tab, c, l, rows, d, f, r, deg_r);
  return launch_wide_nd<M, 33>(grid, s, sp, u, tab, c, l, rows, d, f, r, deg_r);
}

int deg(uint32_t r) { return r ? 31 - __builtin_clz(r) : 0; }

}  // namespace

// K8-A: out[i] = a[i]^(2^m - 2) (e == nullptr) or a[i]^e[i] (the low nbits
// bits of e), i < n, over the (n / cols, cols) output; a (uint8 for m <= 8,
// int64 above) and e (int64) are read at row * rs + col * cs. f is the
// irreducible polynomial of degree m (bit k: coefficient of x^k).
extern "C" int gf2m_power_launch(const void* a, long long a_rs, long long a_cs, const long long* e, long long e_rs,
                                 long long e_cs, int nbits, void* out, long long n, long long cols, int m, unsigned f,
                                 void* stream) {
  if (n <= 0 || cols <= 0 || m < 2 || m > 16 || (f >> m) != 1u || nbits < 0 || nbits > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t r = f ^ (1u << m);
  const long long per_block = m <= 8 ? 16LL * THREADS : 1LL * SCALAR_ELEMS * THREADS;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool contiguous = a_cs == 1 && (cols >= n || a_rs == cols);
  const long long nvec = m <= 8 && contiguous && aligned16(a) && aligned16(out) ? n / 16 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
#define GF2M_POWER_CASE(M) \
  case M: launch_power<M>(grid, s, a, a_rs, a_cs, e, e_rs, e_cs, nbits, out, n, cols, nvec, r, deg(r)); break;
  switch (m) {
    GF2M_POWER_CASE(2) GF2M_POWER_CASE(3) GF2M_POWER_CASE(4) GF2M_POWER_CASE(5) GF2M_POWER_CASE(6)
    GF2M_POWER_CASE(7) GF2M_POWER_CASE(8) GF2M_POWER_CASE(9) GF2M_POWER_CASE(10) GF2M_POWER_CASE(11)
    GF2M_POWER_CASE(12) GF2M_POWER_CASE(13) GF2M_POWER_CASE(14) GF2M_POWER_CASE(15) GF2M_POWER_CASE(16)
  }
#undef GF2M_POWER_CASE
  return static_cast<int>(cudaGetLastError());
}

// K8-B: the masked Berlekamp-Massey scan of `rows` codewords over GF(2^m):
// sp (rows, d - 1) and c (rows, d) in the field's storage (uint8 for
// 2 <= m <= 8, 2 <= d <= 65; int64 for 9 <= m <= 16, 2 <= d <= 33), u and l
// (rows,) int64; tab is pack_tables' table for that storage (int32 byte rows,
// or the 16-byte aligned uint16 segments).
extern "C" int bm_scan_launch(const void* sp, const long long* u, const void* tab, void* c, long long* l,
                              long long rows, int d, int m, unsigned f, void* stream) {
  if (rows <= 0 || d < 2 || d > (m <= 8 ? 65 : 33) || m < 2 || m > 16 || (f >> m) != 1u || !tab ||
      (m > 8 && !aligned16(tab))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = m <= 8 ? BM_THREADS : BM_WIDE_THREADS;
  const long long blocks = (rows + threads - 1) / threads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t r = f ^ (1u << m);
  const int nw = (d + 3) / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto* sp8 = static_cast<const uint8_t*>(sp);
  const auto* tab32 = static_cast<const uint32_t*>(tab);
  auto* c8 = static_cast<uint8_t*>(c);
#define BM_CASE(M) \
  case M: launch_bm<M>(nw, grid, s, sp8, u, tab32, c8, l, rows, d, r); break;
#define BM_WIDE_CASE(M)                                                                                    \
  case M:                                                                                                  \
    e = launch_wide<M>(grid, s, static_cast<const long long*>(sp), u, static_cast<const uint16_t*>(tab),  \
                       static_cast<long long*>(c), l, rows, d, f, r, deg(r));                              \
    break;
  cudaError_t e = cudaSuccess;
  switch (m) {
    BM_CASE(2) BM_CASE(3) BM_CASE(4) BM_CASE(5) BM_CASE(6) BM_CASE(7) BM_CASE(8)
    BM_WIDE_CASE(9) BM_WIDE_CASE(10) BM_WIDE_CASE(11) BM_WIDE_CASE(12) BM_WIDE_CASE(13) BM_WIDE_CASE(14)
    BM_WIDE_CASE(15) BM_WIDE_CASE(16)
  }
#undef BM_CASE
#undef BM_WIDE_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
