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
// Design: one thread an element, its limbs packed into N = 2 ceil(m / 64)
// 32-bit words in registers (N a template parameter, 2..18, so that every
// word index is static).
//   - Product: a comb with a 4-bit window (Lopez-Dahab). The thread builds
//     the 16 multiples t(x) a(x), deg t < 4, of N + 1 words each, in its
//     column of a shared-memory table (entry u, word w at
//     tab[(u (N + 1) + w) THREADS + tid]: a warp's reads of one word hit 32
//     banks whatever the entries, so the data-dependent reads never
//     conflict), then walks b a nibble at a time across all N words at once:
//     8 nibble positions, each N table reads XORed into the 2N-word
//     accumulator, with one 4-bit shift of the accumulator between
//     positions. The 2m - 1 unreduced bits are reduced once, at the end.
//   - Square: squaring is linear in characteristic 2, so a^2 spreads a's
//     bits (a zero after each: a byte permute and three shift-and-mask steps
//     a 16-bit half), then the same reduction. No product.
//   - Reduction, in a frame shifted by s = 32 N - m (x^m sits at bit 32 N,
//     the word boundary, so that every word index is static whatever m):
//     when f - x^m has at most 5 terms and degree d <= m / 2 (GCM's f, every
//     NIST binary curve's), the high half H folds back as sum_i H x^(s + e_i)
//     over the terms' exponents e_i, in two passes (the first leaves at most
//     d - 1 bits above x^m, the second none); the word offsets of s + e_i
//     come from the host and pick one of N + 1 static forms. Any other f folds
//     H top-down a byte at a time through a 256-entry table of
//     (b x^m mod f) x^s, N words an entry, staged in shared memory from the
//     host's table (one per (m, f, device)). Both are exact for every f of
//     degree m.
//   - Powers, one launch a call: the reciprocal a^(2^m - 2) by the
//     Itoh-Tsujii chain (m - 1 squares and about log2(m - 1) + popcount(m - 1)
//     products: 127 squares and 12 products for GF(2^128)); a^(2^j), the
//     square root a^(2^(m - 1)) among them, by j squares; any other public
//     exponent (up to 640 bits), and the per-element exponents of 62-bit
//     int64 words (the exponent-array power, read by stride), by a
//     left-to-right square-and-multiply ladder on the square and product
//     above. The launcher's entry comes from the wrapper, as the plain
//     version chooses it from e.
//
// What bounds it on the H100: the shared-memory words of the comb and the
// integer ALUs, not bytes. A GF(2^128) product moves 48 bytes and costs
// about 360 32-bit operations and 240 shared-memory words (the table's 80
// writes and the comb's 160 reads); at 2^24 elements its byte bound is
// 0.24 ms, its words 0.48 ms at one wavefront a clock per SM, its
// operations 0.35 ms (chip_smoke.py prints the counts). On "NVIDIA H100 80GB
// HBM3, 700.00 W" it takes 1.006 ms, and a 2^22 reciprocal 9.12 ms
// (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

// A public exponent as 64-bit words, passed by value; outside the anonymous
// namespace, so that the extern "C" entry points keep external linkage.
struct Gf2LimbWords {
  unsigned long long w[10];
};

// The reduction's host inputs (ops/_limb_binary.py::fold_inputs): sparse
// f folds by nterms terms of f - x^m, term i at word q[i], bit r[i] of
// the frame (s + e_i = 32 q[i] + r[i]); dense f by the byte table.
struct Gf2LimbFold {
  int sparse;
  int nterms;
  int q[5];
  int r[5];
};

namespace {

constexpr int THREADS = 128;
constexpr int EXP_WORDS = 10;
enum Entry : int { LADDER = 0, INVERSE = 1, SQUARES = 2, WORDS = 3 };

struct Ctx {
  uint32_t* tab;        // this thread's column of the comb table (stride THREADS)
  const uint32_t* red;  // dense f: the 256-entry byte table in shared memory
  Gf2LimbFold fold;
  int s;                // the frame shift 32 N - m
};

template <int N>
__device__ __forceinline__ void load(const uint16_t* __restrict__ a, long long plane, long long idx, int L,
                                     uint32_t (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int l = 2 * k;
    const uint32_t lo = l < L ? __ldg(a + l * plane + idx) : 0u;
    const uint32_t hi = l + 1 < L ? __ldg(a + (l + 1) * plane + idx) : 0u;
    x[k] = lo | (hi << 16);
  }
}

template <int N>
__device__ __forceinline__ void store(uint16_t* __restrict__ out, long long n, long long e, int L,
                                      const uint32_t (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (2 * k < L) out[2 * k * n + e] = static_cast<uint16_t>(x[k]);
    if (2 * k + 1 < L) out[(2 * k + 1) * n + e] = static_cast<uint16_t>(x[k] >> 16);
  }
}

// x <<= s over K words, 0 <= s < 64 (uniform: the branch costs nothing).
template <int K>
__device__ __forceinline__ void shl(uint32_t (&x)[K], int s) {
  if (s >= 32) {
#pragma unroll
    for (int i = K - 1; i > 0; --i) x[i] = x[i - 1];
    x[0] = 0;
    s -= 32;
  }
#pragma unroll
  for (int i = K - 1; i > 0; --i) x[i] = __funnelshift_l(x[i - 1], x[i], s);
  x[0] <<= s;
}

// y = x >> s, the low K words of the 2K-word x, 0 <= s < 64; the bits
// shifted in from above are zero after a reduction.
template <int K>
__device__ __forceinline__ void shr(const uint32_t (&x)[2 * K], uint32_t (&y)[K], int s) {
  if (s >= 32) {
#pragma unroll
    for (int i = 0; i < K; ++i) y[i] = __funnelshift_r(x[i + 1], x[i + 2], s - 32);
    return;
  }
#pragma unroll
  for (int i = 0; i < K; ++i) y[i] = __funnelshift_r(x[i], x[i + 1], s);
}

// c ^= h x^(32 Q + r): word j + Q takes h[j] << r and h[j - 1]'s top r bits.
template <int N, int Q>
__device__ __forceinline__ void fold_term(uint32_t (&c)[2 * N], const uint32_t (&h)[N], int r) {
#pragma unroll
  for (int j = 0; j <= N; ++j) {
    if (j + Q < 2 * N) c[j + Q] ^= __funnelshift_l(j > 0 ? h[j - 1] : 0u, j < N ? h[j] : 0u, r);
  }
}

template <int N, int Q = 0>
__device__ __forceinline__ void fold_term_at(uint32_t (&c)[2 * N], const uint32_t (&h)[N], int q, int r) {
  if constexpr (Q <= N) {
    if (q == Q) {
      fold_term<N, Q>(c, h, r);
    } else {
      fold_term_at<N, Q + 1>(c, h, q, r);
    }
  }
}

// r = c mod f' for the unreduced 2N-word c in the frame (c = C x^s); r in the frame.
template <int N, bool SPARSE>
__device__ __forceinline__ void reduce(uint32_t (&c)[2 * N], const Ctx& X) {
  if constexpr (SPARSE) {
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      uint32_t h[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h[j] = c[N + j];
        c[N + j] = 0;
      }
#pragma unroll 1
      for (int t = 0; t < X.fold.nterms; ++t) fold_term_at<N>(c, h, X.fold.q[t], X.fold.r[t]);
    }
  } else {
    // byte i of the high half, top down: b x^(32 N + 8 i) = T[b] x^(8 i), all of it below byte i
#pragma unroll
    for (int i = 4 * N - 1; i >= 0; --i) {
      const uint32_t b = (c[N + i / 4] >> (8 * (i % 4))) & 0xFFu;
      const uint32_t* t = X.red + b * (N + 1);
      uint32_t prev = 0;
#pragma unroll
      for (int w = 0; w <= N; ++w) {
        const uint32_t cur = w < N ? t[w] : 0u;
        c[i / 4 + w] ^= __funnelshift_l(prev, cur, 8 * (i % 4));
        prev = cur;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) c[N + j] = 0;
  }
}

// r = a b mod f, all in normal form (below x^m).
template <int N, bool SPARSE>
__device__ __forceinline__ void mulmod(const uint32_t (&a)[N], const uint32_t (&b)[N], uint32_t (&r)[N],
                                       const Ctx& X) {
  constexpr int TW = N + 1;
  // the 16 multiples u(x) a(x) x^s, u < 16, N + 1 words each, into this thread's column
  uint32_t t1[TW], t2[TW], t4[TW], t8[TW];
#pragma unroll
  for (int w = 0; w < N; ++w) t1[w] = a[w];
  t1[N] = 0;
  shl<TW>(t1, X.s);
#pragma unroll
  for (int w = TW - 1; w >= 0; --w) {
    const uint32_t lo = w ? t1[w - 1] : 0u;
    t2[w] = __funnelshift_l(lo, t1[w], 1);
    t4[w] = __funnelshift_l(lo, t1[w], 2);
    t8[w] = __funnelshift_l(lo, t1[w], 3);
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) {
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      const uint32_t v = ((u & 1) ? t1[w] : 0u) ^ ((u & 2) ? t2[w] : 0u) ^ ((u & 4) ? t4[w] : 0u) ^
                         ((u & 8) ? t8[w] : 0u);
      X.tab[(u * TW + w) * THREADS] = v;
    }
  }
  // the comb: b's nibbles at position p of every word, top position first
  uint32_t c[2 * N];
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) c[i] = 0;
#pragma unroll 1
  for (int p = 7; p >= 0; --p) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t* e = X.tab + ((b[k] >> (4 * p)) & 15u) * (TW * THREADS);
#pragma unroll
      for (int w = 0; w < TW; ++w) c[k + w] ^= e[w * THREADS];
    }
    if (p) {
#pragma unroll
      for (int i = 2 * N - 1; i > 0; --i) c[i] = __funnelshift_l(c[i - 1], c[i], 4);
      c[0] <<= 4;
    }
  }
  reduce<N, SPARSE>(c, X);
  shr<N>(c, r, X.s);
}

// Spread 16 bits to 32: bit i to bit 2i.
__device__ __forceinline__ uint32_t spread16(uint32_t x, uint32_t sel) {
  x = __byte_perm(x, 0u, sel);
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// r = a^2 mod f, normal form.
template <int N, bool SPARSE>
__device__ __forceinline__ void sqrmod(const uint32_t (&a)[N], uint32_t (&r)[N], const Ctx& X) {
  uint32_t c[2 * N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    c[2 * k] = spread16(a[k], 0x4140u);
    c[2 * k + 1] = spread16(a[k], 0x4342u);
  }
  shl<2 * N>(c, X.s);
  reduce<N, SPARSE>(c, X);
  shr<N>(c, r, X.s);
}

template <int N>
__device__ __forceinline__ void copy(const uint32_t (&a)[N], uint32_t (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = a[k];
}

// The block's shared memory: the comb table (16 (N + 1) words a thread), then
// the dense byte table, an entry every N + 1 words (an odd stride, so that
// the data-dependent entries spread over the banks); staged before any
// thread may return.
template <int N, bool SPARSE>
__device__ __forceinline__ Ctx context(const Gf2LimbFold& fold, const uint32_t* __restrict__ red, int s) {
  extern __shared__ uint32_t smem[];
  Ctx X{smem + threadIdx.x, nullptr, fold, s};
  if constexpr (!SPARSE) {
    uint32_t* t = smem + 16 * (N + 1) * THREADS;
    for (int i = threadIdx.x; i < 256 * N; i += THREADS) t[i / N * (N + 1) + i % N] = __ldg(red + i);
    __syncthreads();
    X.red = t;
  }
  return X;
}

template <int N, bool SPARSE>
__global__ void __launch_bounds__(THREADS) mul_kernel(const uint16_t* __restrict__ a, long long ap, long long ae,
                                                      const uint16_t* __restrict__ b, long long bp, long long be,
                                                      uint16_t* __restrict__ out, long long n, int L, int s,
                                                      Gf2LimbFold fold, const uint32_t* __restrict__ red, int square) {
  const Ctx X = context<N, SPARSE>(fold, red, s);
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t x[N], r[N];
  load<N>(a, ap, e * ae, L, x);
  if (square) {
    sqrmod<N, SPARSE>(x, r, X);
  } else {
    uint32_t y[N];
    load<N>(b, bp, e * be, L, y);
    mulmod<N, SPARSE>(x, y, r, X);
  }
  store<N>(out, n, e, L, r);
}

template <int N, bool SPARSE>
__global__ void __launch_bounds__(THREADS) pow_kernel(const uint16_t* __restrict__ a, long long ap, long long ae,
                                                      uint16_t* __restrict__ out, long long n, int L, int m, int s,
                                                      Gf2LimbFold fold, const uint32_t* __restrict__ red, int entry,
                                                      Gf2LimbWords ex, int nbits, const long long* __restrict__ ew,
                                                      long long ews, long long ees) {
  const Ctx X = context<N, SPARSE>(fold, red, s);
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= n) return;
  uint32_t x[N], t[N], u[N];
  load<N>(a, ap, e * ae, L, x);
  // One chain of steps "t = t^(2^nsq), then t = t y", y the base or the t of
  // the step's start, so that the square and the product are inlined once.
  // The reciprocal (Itoh-Tsujii): t = a^(2^k - 1) along the bits of m - 1
  // below the top one (k -> 2k: t^(2^k) t; k -> k + 1: t^2 a), then t^2.
  // a^(2^nbits): one step of nbits squares. The ladders: t = 1, then per bit
  // from the top a square and, where the bit is set, a product by a.
  if (entry == LADDER || entry == WORDS) {
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = k == 0 ? 1u : 0u;
  } else {
    copy<N>(x, t);
  }
  int i = entry == INVERSE ? 30 - __clz(m - 1) : nbits - 1, k = 1;
  bool plus_one = false, done = false;
  while (!done) {
    int nsq = 1;
    bool mult = true, saved = false;
    if (entry == INVERSE) {
      if (plus_one) {  // k -> k + 1
        plus_one = false;
        ++k;
        --i;
      } else if (i >= 0) {  // k -> 2k
        nsq = k;
        saved = true;
        k *= 2;
        plus_one = ((m - 1) >> i) & 1;
        if (!plus_one) --i;
      } else {  // the last square
        mult = false;
        done = true;
      }
    } else if (entry == SQUARES) {
      nsq = nbits;
      mult = false;
      done = true;
    } else {
      if (i < 0) break;
      mult = entry == WORDS ? (__ldg(ew + (i / 62) * ews + e * ees) >> (i % 62)) & 1 : (ex.w[i / 64] >> (i % 64)) & 1;
      --i;
    }
    if (saved) copy<N>(t, u);
    for (int j = 0; j < nsq; ++j) sqrmod<N, SPARSE>(t, t, X);
    if (mult) {
#pragma unroll
      for (int w = 0; w < N; ++w) u[w] = saved ? u[w] : x[w];
      mulmod<N, SPARSE>(t, u, t, X);
    }
  }
  store<N>(out, n, e, L, t);
}

bool valid(long long n, int m, const Gf2LimbFold& fold, const void* red) {
  return n > 0 && m > 32 && m <= 64 * 9 && (fold.sparse ? fold.nterms >= 1 && fold.nterms <= 5 : red != nullptr);
}

dim3 grid_for(long long n) { return dim3(static_cast<unsigned>((n + THREADS - 1) / THREADS)); }

template <int N, bool SPARSE>
constexpr size_t smem_bytes() {
  return (16 * (N + 1) * THREADS + (SPARSE ? 0 : 256 * (N + 1))) * sizeof(uint32_t);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

template <int N, bool SPARSE>
cudaError_t mul_at(const uint16_t* a, long long ap, long long ae, const uint16_t* b, long long bp, long long be,
                   uint16_t* out, long long n, int m, const Gf2LimbFold& fold, const uint32_t* red, int square,
                   cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<N, SPARSE>();
  const cudaError_t err = allow_smem(mul_kernel<N, SPARSE>, bytes);
  if (err != cudaSuccess) return err;
  mul_kernel<N, SPARSE><<<grid_for(n), THREADS, bytes, st>>>(a, ap, ae, b, bp, be, out, n, (m + 15) / 16,
                                                              32 * N - m, fold, red, square);
  return cudaGetLastError();
}

template <int N, bool SPARSE>
cudaError_t pow_at(const uint16_t* a, long long ap, long long ae, uint16_t* out, long long n, int m,
                   const Gf2LimbFold& fold, const uint32_t* red, int entry, const Gf2LimbWords& ex, int nbits,
                   const long long* ew, long long ews, long long ees, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<N, SPARSE>();
  const cudaError_t err = allow_smem(pow_kernel<N, SPARSE>, bytes);
  if (err != cudaSuccess) return err;
  pow_kernel<N, SPARSE><<<grid_for(n), THREADS, bytes, st>>>(a, ap, ae, out, n, (m + 15) / 16, m, 32 * N - m, fold,
                                                              red, entry, ex, nbits, ew, ews, ees);
  return cudaGetLastError();
}

}  // namespace

#define GF2_LIMB_CASES(CALL)                                                          \
  switch ((m + 63) / 64) {                                                             \
    case 1: err = fold.sparse ? CALL(2, true) : CALL(2, false); break;                 \
    case 2: err = fold.sparse ? CALL(4, true) : CALL(4, false); break;                 \
    case 3: err = fold.sparse ? CALL(6, true) : CALL(6, false); break;                 \
    case 4: err = fold.sparse ? CALL(8, true) : CALL(8, false); break;                 \
    case 5: err = fold.sparse ? CALL(10, true) : CALL(10, false); break;               \
    case 6: err = fold.sparse ? CALL(12, true) : CALL(12, false); break;               \
    case 7: err = fold.sparse ? CALL(14, true) : CALL(14, false); break;               \
    case 8: err = fold.sparse ? CALL(16, true) : CALL(16, false); break;               \
    default: err = fold.sparse ? CALL(18, true) : CALL(18, false); break;              \
  }

// out (L, n) = a * b over GF(2^m), or a^2 where square != 0 (b unread); a and b
// planar uint16 limbs read at a[k * ap + e * ae]; fold and red: the reduction's
// host inputs for f.
extern "C" int gf2_limb_mul_launch(const uint16_t* a, long long ap, long long ae, const uint16_t* b, long long bp,
                                   long long be, uint16_t* out, long long n, int m, Gf2LimbFold fold,
                                   const unsigned* red, int square, void* stream) {
  if (!valid(n, m, fold, red) || (!square && !b)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define MUL_CALL(N, S) mul_at<N, S>(a, ap, ae, b, bp, be, out, n, m, fold, red, square, st)
  GF2_LIMB_CASES(MUL_CALL)
#undef MUL_CALL
  return static_cast<int>(err);
}

// out (L, n) = a^e over GF(2^m). entry 0: the ladder over the public
// exponent ex (nbits bits); 1: the reciprocal a^(2^m - 2); 2: a^(2^nbits);
// 3: the ladder where bit i of element e's exponent is bit i % 62 of
// ew[(i / 62) * ews + e * ees].
extern "C" int gf2_limb_pow_launch(const uint16_t* a, long long ap, long long ae, uint16_t* out, long long n, int m,
                                   Gf2LimbFold fold, const unsigned* red, int entry, Gf2LimbWords ex, int nbits,
                                   const long long* ew, long long ews, long long ees, void* stream) {
  if (!valid(n, m, fold, red) || nbits < 0 || entry < LADDER || entry > WORDS ||
      (entry == LADDER && nbits > 64 * EXP_WORDS) || (entry == WORDS && !ew)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define POW_CALL(N, S) pow_at<N, S>(a, ap, ae, out, n, m, fold, red, entry, ex, nbits, ew, ews, ees, st)
  GF2_LIMB_CASES(POW_CALL)
#undef POW_CALL
  return static_cast<int>(err);
}
