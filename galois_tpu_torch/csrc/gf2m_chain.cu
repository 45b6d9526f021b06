// Kernels K8-A and K8-B: GF(2^m) maps of the decoders over the field's own
// tables in shared memory (ops/_lookup.py::pack_tables' layout, staged as
// lookup.cuh stages them for K3-K6).
//
// K8-A, gf2m_power: out = a^e elementwise in GF(2^m), 2 <= m <= 16, in the
// field's storage dtype (uint8 for m <= 8, int64 above). Wrapper and plain
// torch version: ops/_elementwise.py::gf2m_power. The exponent is either
//   - absent: the reciprocal a^(2^m - 2), 0 at a = 0 (the plain chain and the
//     JAX package give 0 there; pack_tables' INV[0] is 1, so the kernel
//     masks zero itself); or
//   - a per-element int64 exponent tensor. Only its low nbits bits count, as
//     in the plain ladder over nbits bits; each is reduced to e' in
//     [0, 2^m - 1] (e' = 0 only where those bits are 0, else
//     e' = (e - 1) mod (2^m - 1) + 1), and a^e = 1 where e' = 0, 0 where
//     a = 0 < e', else EXP[(LOG a * e') mod (2^m - 1)]. The product is below
//     2^(2m) <= 2^32 and is reduced by two folds x = (x & (2^m - 1)) +
//     (x >> m) and one conditional subtract, with no division.
// It replaces the torch chains of ops/_kernels.py BinaryExtOps.reciprocal,
// power and power_static. The JAX references are BinaryExtOps.reciprocal and
// FieldOps.power of galois_tpu/ops/_kernels.py; no Pallas kernel computes
// these maps (XLA fused them on the TPU).
// Design: the reciprocal of an operand laid out as the output is K5's pass
// (lookup.cuh) with zero masked: 16-byte evict-first streams, one read of
// INV a element (byte 3 of the byte rows for m <= 8 with nonzero_bytes on
// whole words, the staged uint16 INV segment above; 128 KB at m = 16, one
// block of 1024 threads a SM). Every other call (an exponent tensor, a 0-D
// exponent, a strided base) is one element a thread and step of a
// grid-stride pass: operands that are whole tensors or single elements
// (the decoder's 0-D g against (B, d) exponents, power_static's 0-D
// exponent) at offset i or 0, four elements' loads in flight, any other at
// its element strides along the output's merged axes (lookup.cuh's Coord),
// with LOG and EXP read from the byte rows (m <= 8), LOG and the reduced EXP
// staged in shared memory (m <= 14, at most 64 KB) or LOG staged and EXP
// through __ldg out of L1 and L2 (m = 15, 16; K3's log-shared).
// What bounds it: HBM bytes, 2 a element for a uint8 reciprocal and 16 for
// an int64 one, 8 more for each element of an int64 exponent tensor. The
// first design ran the Itoh-Tsujii chain on the TPU SWAR multiply's core in
// registers, about 1117 32-bit operations per word of four elements at
// m = 8, and was bound by the integer ALUs (0.227 ms for 2^24 GF(2^8)
// reciprocals on an H100 80GB HBM3 at 700 W, against 0.0115 ms now; PERF.md).
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
//   - delta = sum_i C[i] S'[t - i]: the carry-less products (m <= 8: the
//     TPU SWAR multiply's nibble Karatsuba in byte slots, gf2m_swar.cuh;
//     above: the one-lane ladder) are XOR-summed unreduced, then reduced once (the reduction is linear, so
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
#include "lookup.cuh"

namespace {

constexpr int BM_THREADS = 64;   // K8-B, m <= 8: 1024 blocks for 65536 rows, about 8 per SM
constexpr int BM_BLOCKS_PER_SM = 8;  // so up to 128 registers a thread: no spills at 17 words
constexpr int BM_WIDE_THREADS = 128;  // K8-B, 9 <= m <= 16: up to 3 x 33 elements in registers

// ---- K8-B, 9 <= m <= 16: one element per 32-bit lane ----

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

// ---- K8-A ----

// Threads a block: the byte rows (32 KB at m = 8), LOG and the reduced EXP
// (at most 64 KB) and LOG alone (128 KB at m = 16, one block a SM), as K5.
__host__ __device__ constexpr int pow_threads(int m) { return m <= 8 ? BYTE_THREADS : m <= 14 ? 512 : 1024; }

// The exponent's low nbits bits, reduced to e' in [0, 2^M - 1] with the same
// power for every a (see the head); M is a compile-time constant, so the
// modulo is a multiply.
template <int M>
__device__ __forceinline__ uint32_t reduce_exponent(long long e, int nbits) {
  unsigned long long v = static_cast<unsigned long long>(e);
  if (nbits < 64) v &= (1ull << nbits) - 1;
  constexpr unsigned long long Q1 = (1ull << M) - 1;
  return v == 0 ? 0u : static_cast<uint32_t>((v - 1) % Q1 + 1);
}

// x mod (2^M - 1) for x < 2^(2M): two folds leave at most 2^M, then one
// conditional subtract.
template <int M>
__device__ __forceinline__ uint32_t mod_q1(uint32_t x) {
  constexpr uint32_t Q1 = (1u << M) - 1;
  x = (x & Q1) + (x >> M);
  x = (x & Q1) + (x >> M);
  return x >= Q1 ? x - Q1 : x;
}

// out = a^e' over the output's n elements, a (uint8 for M <= 8, int64
// above) and e (int64) read at their strides; e null: every e' is e_fixed
// (2^M - 2 for a strided reciprocal, 0 < e_fixed < 2^M). tab: pack_tables'
// table of the field, the byte rows (M <= 8) or the uint16 segments.
// a_unit, e_unit: flat_unit's 1 or 0 where every operand has one (offsets
// i * unit, no walk), else -1.
template <int M>
__global__ void __launch_bounds__(pow_threads(M))
power_kernel(const void* __restrict__ a, Strides as, long long a_unit, const long long* __restrict__ e, Strides es,
             long long e_unit, int nbits, uint32_t e_fixed, void* __restrict__ out, Axes ax,
             const void* __restrict__ tab) {
  constexpr int THREADS = pow_threads(M);
  constexpr int Q = 1 << M, Q8 = (Q + 7) & ~7, E8 = (Q - 1 + 7) & ~7;
  extern __shared__ uint4 smem[];
  if constexpr (M <= 8) stage_byte_rows(smem, static_cast<const uint32_t*>(tab), Q, THREADS);
  else stage_u16(smem, static_cast<const uint16_t*>(tab), M <= 14 ? Q8 + E8 : Q8, THREADS);
  const uint8_t* col = reinterpret_cast<const uint8_t*>(smem) + 4 * (threadIdx.x & 31);
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(smem);
  const uint16_t* exp16 = M <= 14 ? s16 + Q8 : static_cast<const uint16_t*>(tab) + Q8;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;
  auto load_a = [a](long long oa) -> uint32_t {
    if constexpr (M <= 8) return __ldg(static_cast<const uint8_t*>(a) + oa);
    else return static_cast<uint32_t>(__ldg(static_cast<const long long*>(a) + oa));
  };
  // element i of the output from its base x and its exponent's low word(s) ew
  auto element = [&](long long i, uint32_t x, long long ew) {
    uint32_t r;
    const uint32_t ev = e ? reduce_exponent<M>(ew, nbits) : e_fixed;
    if constexpr (M <= 8) {
      r = col[mod_q1<M>(col[x * ROW] * ev) * ROW + 1];
    } else {
      const uint32_t t = mod_q1<M>(s16[x] * ev);
      r = M <= 14 ? exp16[t] : __ldg(exp16 + t);
    }
    r = ev == 0 ? 1u : x == 0 ? 0u : r;
    if constexpr (M <= 8) static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(r);
    else static_cast<long long*>(out)[i] = r;
  };
  if (a_unit >= 0 && e_unit >= 0) {  // whole tensors and single elements: no walk, U elements' loads in flight
    constexpr int U = 4;
    for (long long i0 = tid; i0 < ax.n; i0 += U * nthreads) {
      uint32_t x[U];
      long long ew[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = i0 + u * nthreads;
        if (i < ax.n) x[u] = load_a(i * a_unit), ew[u] = e ? __ldg(e + i * e_unit) : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * nthreads < ax.n) element(i0 + u * nthreads, x[u], ew[u]);
    }
    return;
  }
  if (tid >= ax.n) return;
  Coord c(tid, ax);
  long long oa = c.offset(tid, as, ax), oe = e ? c.offset(tid, es, ax) : 0;
  for (long long i = tid; i < ax.n; i += nthreads) {
    element(i, load_a(oa), e ? __ldg(e + oe) : 0);
    bool carry2, carry1;
    c.step(ax, carry2, carry1);
    advance(oa, as, carry2, carry1);
    if (e) advance(oe, es, carry2, carry1);
  }
}

template <int M>
cudaError_t launch_power(const void* a, const long long (&ast)[3], const long long* e, const long long (&est)[3],
                         int nbits, void* out, long long n, long long n1, long long n2, const void* tab,
                         cudaStream_t s) {
  constexpr int Q = 1 << M, Q8 = (Q + 7) & ~7, E8 = (Q - 1 + 7) & ~7;
  constexpr int smem = M <= 8 ? Q * static_cast<int>(ROW) : 2 * (M <= 14 ? Q8 + E8 : Q8);
  auto kernel = power_kernel<M>;
  unsigned blocks = 0;
  cudaError_t err = persistent_grid(kernel, pow_threads(M), smem, n, &blocks);
  if (err != cudaSuccess) return err;
  const long long step = static_cast<long long>(blocks) * pow_threads(M), n0 = n / (n1 * n2);
  const Axes ax = make_axes(n, n1, n2, step);
  kernel<<<blocks, pow_threads(M), smem, s>>>(
      a, make_strides(ast[0], ast[1], ast[2], ax, step), flat_unit(ast[0], ast[1], ast[2], n0, n1, n2), e,
      make_strides(est[0], est[1], est[2], ax, step), e ? flat_unit(est[0], est[1], est[2], n0, n1, n2) : 0, nbits,
      static_cast<uint32_t>(Q - 2), out, ax, tab);
  return cudaGetLastError();
}

// ---- K8-B ----

// XOR-accumulate the unreduced byte-slot products of the words x and y:
// for M <= 4 one ladder (7-bit slot products), above it the nibble
// Karatsuba pieces of the TPU's SWAR multiply lo*lo, hi*hi and (lo^hi)*(lo^hi), each summed apart.
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
// bits of e) over the output's n elements, (n / (n1 n2), n1, n2), 16-byte
// aligned; a (uint8 for m <= 8, int64 above) and e (int64) are read at
// element strides (s0, s1, s2) along those axes. tab: pack_tables' table of
// the field for that storage (the byte rows, or the uint16 segments), 16-byte
// aligned.
extern "C" int gf2m_power_launch(const void* a, long long as0, long long as1, long long as2, const long long* e,
                                 long long es0, long long es1, long long es2, int nbits, void* out, long long n,
                                 long long n1, long long n2, int m, const void* tab, void* stream) {
  if (n <= 0 || n1 <= 0 || n2 <= 0 || n % (n1 * n2) || m < 2 || m > 16 || nbits < 0 || nbits > 64 ||
      !aligned16(out) || !aligned16(tab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!e && flat_unit(as0, as1, as2, n / (n1 * n2), n1, n2) == 1) {  // K5's pass, zero masked
    const int place = m <= 8 ? PLACE_BYTES : m <= 14 ? PLACE_SHARED : PLACE_LOG_SHARED;
    return static_cast<int>(launch_unary<OP_RECIP, true>(place, a, out, tab, nullptr, nullptr, 1 << m, n, s));
  }
  const long long ast[3] = {as0, as1, as2}, est[3] = {es0, es1, es2};
  cudaError_t err = cudaErrorInvalidValue;
#define GF2M_POWER_CASE(M) \
  case M: err = launch_power<M>(a, ast, e, est, nbits, out, n, n1, n2, tab, s); break;
  switch (m) {
    GF2M_POWER_CASE(2) GF2M_POWER_CASE(3) GF2M_POWER_CASE(4) GF2M_POWER_CASE(5) GF2M_POWER_CASE(6)
    GF2M_POWER_CASE(7) GF2M_POWER_CASE(8) GF2M_POWER_CASE(9) GF2M_POWER_CASE(10) GF2M_POWER_CASE(11)
    GF2M_POWER_CASE(12) GF2M_POWER_CASE(13) GF2M_POWER_CASE(14) GF2M_POWER_CASE(15) GF2M_POWER_CASE(16)
  }
#undef GF2M_POWER_CASE
  return static_cast<int>(err);
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
