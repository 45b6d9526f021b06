// Kernel K16: the combine of the Goldilocks limb matmul, from a chunk's 19
// int32 diagonal sums to the canonical residues' uint16 limbs.
//
// No Pallas kernel is replaced: the JAX package combines the diagonals with
// jnp elementwise ops outside any kernel (galois_tpu/ops/_limb_matmul.py::
// goldilocks_matmul, _gold_mul_small, _gold_add), and the port ran a chain of
// torch int64 passes (the cast, shifts and index_add_ into limb columns,
// carries, a fold by 2^64 mod p and Barrett), kept as the plain version.
// Wrapper and plain torch version: ops/_limb_matmul.py (goldilocks_combine,
// goldilocks_combine_plain); its caller is _core's Goldilocks path, once a
// chunk of output columns and K block.
//
// What it computes: with D_s (s = 0..18) the int32 sums of the products of
// A's 7-bit digit i and B's digit s - i, an element of the product is
// X = sum_s D_s 2^(7s) mod p, p = 2^64 - 2^32 + 1. Each term D_s c_s, with
// c_s = 2^(7s) mod p a compile-time constant, is a 32 x 64 -> 96-bit product
// added into a 128-bit sum (below 19 2^32 2^64 < 2^101); the sum is reduced
// once with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p) and a conditional
// subtract. With `accumulate` (K past one block) the residue that out holds
// is added into the sum first, so later blocks add mod p into what the
// earlier ones wrote; no scratch is kept in device memory.
//
// What bounds it on the H100: bytes. An element reads 19 int32 (76 B) and
// writes 4 uint16 (8 B); at the LDE's four sides (3 2^26 elements a call)
// that is 16.9 GB, 5.0 ms at 3.35 TB/s. The arithmetic is about 150 32-bit
// integer operations an element, some 2 ms at the int32 rate. The design is
// about bytes: one read of the diagonals, one write of the limbs.
// - A thread takes 4 adjacent columns of one row: each diagonal's 16 bytes
//   in one load, neighbouring threads on neighbouring addresses, the 19
//   loads issued before any arithmetic; each limb's 4 values in one 8-byte
//   store. Where the strides or pointers do not allow that, a thread takes
//   one element with scalar loads and stores.
// - The grid's x dimension covers a row's columns, its y dimension the rows
//   (a loop past 65535), so no thread divides; the ragged edge is masked.
// - The output is a view with its own strides (the chunk's columns of the
//   whole product), written in place.
//
// The entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr int THREADS = 256;
constexpr int S = 19;  // diagonals of 10 seven-bit digit planes a side
constexpr uint64_t GOLD_P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p = 2^32 - 1

// 2^e mod p by doubling, at compile time.
__host__ __device__ constexpr uint64_t pow2_mod_p(int e) {
  uint64_t x = 1;
  for (int i = 0; i < e; ++i) {
    uint64_t y = x << 1;
    if (x >> 63) y += EPS;  // the doubling wrapped: 2^64 = EPS (mod p), and y + EPS = 2x - p < p
    if (y >= GOLD_P) y -= GOLD_P;
    x = y;
  }
  return x;
}

static_assert(pow2_mod_p(7 * 10) == 0x3FFFFFFFC0ull, "2^70 mod p");
static_assert(pow2_mod_p(7 * 18) == 0xFFFFFFFEC0000001ull, "2^126 mod p");

// (hi:lo) += d * C, d < 2^32 and C < 2^64 a constant: two 32 x 32 -> 64-bit
// products, folded to shifts or nothing where C's halves allow.
template <uint64_t C>
__device__ __forceinline__ void mac(uint64_t& lo, uint64_t& hi, uint32_t d) {
  constexpr uint32_t c0 = static_cast<uint32_t>(C);
  constexpr uint32_t c1 = static_cast<uint32_t>(C >> 32);
  const uint64_t p0 = static_cast<uint64_t>(d) * c0;
  const uint64_t p1 = static_cast<uint64_t>(d) * c1;
  const uint64_t t = p0 + (p1 << 32);  // d C = t + 2^64 ((p1 >> 32) + carry)
  const uint64_t t_hi = (p1 >> 32) + (t < p0 ? 1u : 0u);
  lo += t;
  hi += t_hi + (lo < t ? 1u : 0u);
}

// The canonical residue of hi 2^64 + lo, any 128-bit value:
// lo + (2^32 - 1) hi_lo - hi_hi (mod p), two wrapping steps and a subtract.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;  // the borrow took 2^64 = EPS (mod p); t0 >= 2^64 - 2^32 here
  const uint64_t t1 = hi_lo * EPS;  // < 2^64
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;  // the carry gave 2^64 = EPS (mod p); no second carry
  return t2 >= GOLD_P ? t2 - GOLD_P : t2;
}

// sum_s d[s] 2^(7s) + prev, mod p.
template <int... s>
__device__ __forceinline__ uint64_t combine(const uint32_t (&d)[S], uint64_t prev, std::integer_sequence<int, s...>) {
  uint64_t lo = prev, hi = 0;
  (mac<pow2_mod_p(7 * s)>(lo, hi, d[s]), ...);
  return reduce128(lo, hi);
}

template <int E> struct Vec;
template <> struct Vec<4> { using D = int4; using O = ushort4; };
template <> struct Vec<1> { using D = int; using O = unsigned short; };

// diag: (S, rows, cols) int32 at strides (plane, drow, 1); out: (4, rows,
// cols) uint16 at strides (limb, orow, 1). E columns a thread.
template <int E, bool ACC>
__global__ void __launch_bounds__(THREADS)
gold_combine_kernel(const int32_t* __restrict__ diag, long long plane, long long drow, uint16_t* __restrict__ out,
                    long long limb, long long orow, long long rows, int cols) {
  using DV = typename Vec<E>::D;
  using OV = typename Vec<E>::O;
  const int j = E * static_cast<int>(blockIdx.x * THREADS + threadIdx.x);
  if (j >= cols) return;
  for (long long m = blockIdx.y; m < rows; m += gridDim.y) {
    const int32_t* d = diag + m * drow + j;
    DV v[S];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = __ldg(reinterpret_cast<const DV*>(d + s * plane));
    uint16_t* o = out + m * orow + j;
    uint64_t prev[E] = {};
    if constexpr (ACC) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const OV w = *reinterpret_cast<const OV*>(o + l * limb);
#pragma unroll
        for (int e = 0; e < E; ++e) prev[e] |= static_cast<uint64_t>(reinterpret_cast<const uint16_t*>(&w)[e]) << (16 * l);
      }
    }
    uint64_t r[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      uint32_t de[S];
#pragma unroll
      for (int s = 0; s < S; ++s) de[s] = reinterpret_cast<const uint32_t*>(&v[s])[e];
      r[e] = combine(de, prev[e], std::make_integer_sequence<int, S>{});
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      OV w;
#pragma unroll
      for (int e = 0; e < E; ++e) reinterpret_cast<uint16_t*>(&w)[e] = static_cast<uint16_t>(r[e] >> (16 * l));
      *reinterpret_cast<OV*>(o + l * limb) = w;
    }
  }
}

template <int E>
cudaError_t launch(const int32_t* diag, long long plane, long long drow, uint16_t* out, long long limb, long long orow,
                   long long rows, int cols, bool accumulate, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((cols / E + THREADS - 1) / THREADS),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  if (accumulate) {
    gold_combine_kernel<E, true><<<grid, THREADS, 0, stream>>>(diag, plane, drow, out, limb, orow, rows, cols);
  } else {
    gold_combine_kernel<E, false><<<grid, THREADS, 0, stream>>>(diag, plane, drow, out, limb, orow, rows, cols);
  }
  return cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }

}  // namespace

// K16: out[:, m, j] = the limbs of (sum_s diag[s, m, j] 2^(7s) (+ out's own
// residue with accumulate)) mod p, for 0 <= m < rows, 0 <= j < cols. diag's
// entries are read as unsigned 32-bit sums; out must hold canonical residues
// where accumulate is set. Strides are in elements; the inner ones are 1.
extern "C" int gold_combine(const int32_t* diag, long long plane, long long drow, void* out, long long limb,
                            long long orow, long long rows, int cols, int accumulate, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  uint16_t* o = static_cast<uint16_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = cols % 4 == 0 && plane % 4 == 0 && drow % 4 == 0 && limb % 4 == 0 && orow % 4 == 0 &&
                   aligned(diag, 16) && aligned(o, 8);
  return static_cast<int>(vec ? launch<4>(diag, plane, drow, o, limb, orow, rows, cols, accumulate != 0, s)
                              : launch<1>(diag, plane, drow, o, limb, orow, rows, cols, accumulate != 0, s));
}
