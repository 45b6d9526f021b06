// Kernel K8: GF(2^m) multiply, 2 <= m <= 8, four elements per 32-bit word.
//
// Replaces galois_tpu/ops/_pallas/_elementwise.py:447 gf2m_multiply_swar_pallas
// (pl.pallas_call :478) with its helpers _swar_rep (:382), _swar_fold (:387),
// _swar_nib_ladder (:405) and _swar_mul_core (:420). Wrapper and plain torch
// version: ops/_elementwise.py::gf2m_multiply_swar. It is the kernel behind
// BinaryExtOps.multiply for GF(2^m), 2 <= m <= 8 (uint8 storage), so every
// GF(2^8) product of the port runs on it: the headline x * y and the
// Reed-Solomon decoder's Berlekamp-Massey, polynomial products and Forney.
//
// What it computes, exactly as _swar_mul_core: four uint8 elements ride one
// u32 word. For m <= 4 a shift-and-XOR ladder builds the carry-less products
// in their byte slots (the 0/1 bit of each byte widens to a 0x7F byte mask
// as (bit << 7) - bit; no borrow crosses a slot). For m > 4 a nibble
// Karatsuba keeps every partial product under 8 bits: lo*lo, hi*hi and
// (lo^hi)*(lo^hi), each a 4-step ladder; the 15-bit products are re-slotted
// into 16-bit slots of the even and the odd bytes. Then constant folds by
// r = f ^ x^m reduce each slot from 2m - 1 bits to m.
//
// What bounds it on the H100: the integer ALUs, as for K7. A product moves
// 3 bytes (2^24 of them: 50.3 MB, 0.0150 ms at 3.35 TB/s), and costs about
// 40 32-bit operations here for m = 8 (some 160 per word of four; K7's
// one-element ladder: about 60), some 0.7e9 operations per 2^24 products.
// Measured at 2^24 on an H100 80GB HBM3 at its 700 W limit: 0.0329 ms,
// against K7's 0.0608 ms on the same inputs.
//
// Design for the card, not the TPU's blocks:
// - the port already stores these fields as uint8, and a contiguous uint8
//   buffer read as 32-bit words costs nothing here (on the TPU the relayout
//   of that reinterpretation kept SWAR off the default path);
// - each thread loads 16 bytes of a and of b (16 elements in 4 words) with
//   one 16-byte load each, runs the ladders and both folds on the 4 words in
//   registers (the 4 words are independent: instruction-level parallelism),
//   and stores 16 bytes;
// - the ragged tail (n mod 16), and every chunk when a pointer is not 16-byte
//   aligned, takes byte loads and stores in the same kernel;
// - m is a template parameter; f comes in as r = f ^ x^m and its degree, so
//   the fold's trip counts and shifts are the same for every thread of the
//   launch (uniform branches, no divergence);
// - no padding to (32, 1024) tiles: the TPU's layout work is not carried over.
//
// The entry point returns cudaGetLastError() after its launch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t ONES = 0x01010101u;  // bit 0 of every byte
constexpr uint32_t NIB = 0x0F0F0F0Fu;   // low nibble of every byte
constexpr uint32_t EVEN = 0x00FF00FFu;  // the even bytes

// Carry-less x * (NBITS low bits of y) in byte slots; x holds at most 4-bit
// values per byte and NBITS <= 4, so every slot's product stays below 2^7.
template <int NBITS>
__device__ __forceinline__ uint32_t nib_ladder(uint32_t x, uint32_t y) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NBITS; ++i) {
    const uint32_t bit = (y >> i) & ONES;
    acc ^= (x << i) & ((bit << 7) - bit);
  }
  return acc;
}

// Reduce (2M - 1)-bit slot values mod f inside SLOT-bit slots of W words:
// each step folds the bits at and above x^M down by r (x^M = r mod f).
template <int M, int SLOT, int W>
__device__ __forceinline__ void fold(uint32_t (&c)[W], uint32_t r, int deg_r) {
  constexpr uint32_t REP1 = SLOT == 8 ? 0x01010101u : 0x00010001u;
  constexpr uint32_t LOW = ((1u << M) - 1) * REP1;
  int width = 2 * M - 1;
  while (width > M) {  // the same trip count in every thread
    const uint32_t hmask = ((1u << (width - M)) - 1) * REP1;
    uint32_t h[W], t[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      h[k] = (c[k] >> M) & hmask;
      t[k] = 0;
    }
    for (uint32_t j = r; j; j &= j - 1) {  // the set bits of r
      const int s = __ffs(j) - 1;
#pragma unroll
      for (int k = 0; k < W; ++k) t[k] ^= h[k] << s;
    }
#pragma unroll
    for (int k = 0; k < W; ++k) c[k] = (c[k] & LOW) ^ t[k];
    width = max(M, width - M + deg_r);
  }
}

// A <- A * B in GF(2^M), four packed elements per word.
template <int M>
__device__ __forceinline__ void mul_core(uint32_t (&A)[4], const uint32_t (&B)[4], uint32_t r, int deg_r) {
  if constexpr (M <= 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) A[k] = nib_ladder<M>(A[k], B[k]);
    fold<M, 8, 4>(A, r, deg_r);
  } else {
    uint32_t p[8];  // p[0..3]: even-byte products, p[4..7]: odd-byte products
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t al = A[k] & NIB, ah = (A[k] >> 4) & NIB;
      const uint32_t bl = B[k] & NIB, bh = (B[k] >> 4) & NIB;
      const uint32_t ll = nib_ladder<4>(al, bl);
      const uint32_t hh = nib_ladder<M - 4>(ah, bh);
      const uint32_t mid = nib_ladder<4>(al ^ ah, bl ^ bh) ^ ll ^ hh;
      p[k] = ((hh & EVEN) << 8) ^ ((mid & EVEN) << 4) ^ (ll & EVEN);
      p[k + 4] = (((hh >> 8) & EVEN) << 8) ^ (((mid >> 8) & EVEN) << 4) ^ ((ll >> 8) & EVEN);
    }
    fold<M, 16, 8>(p, r, deg_r);
#pragma unroll
    for (int k = 0; k < 4; ++k) A[k] = p[k] | (p[k + 4] << 8);
  }
}

// One thread per 16-element chunk; chunks below nvec take 16-byte loads and
// stores, the rest (the ragged tail, or all of them when a pointer is not
// 16-byte aligned) byte loads and stores.
template <int M>
__global__ void __launch_bounds__(THREADS)
swar_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, uint8_t* __restrict__ out,
            long long n, long long nvec, uint32_t r, int deg_r) {
  const long long chunk = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long base = chunk * 16;
  if (base >= n) return;
  uint32_t A[4], B[4];
  const bool vec = chunk < nvec;
  if (vec) {
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + chunk);
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b) + chunk);
    A[0] = va.x, A[1] = va.y, A[2] = va.z, A[3] = va.w;
    B[0] = vb.x, B[1] = vb.y, B[2] = vb.z, B[3] = vb.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      A[k] = 0, B[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + 4 * k + j;
        if (i < n) {
          A[k] |= static_cast<uint32_t>(a[i]) << (8 * j);
          B[k] |= static_cast<uint32_t>(b[i]) << (8 * j);
        }
      }
    }
  }
  mul_core<M>(A, B, r, deg_r);
  if (vec) {
    reinterpret_cast<uint4*>(out)[chunk] = make_uint4(A[0], A[1], A[2], A[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + 4 * k + j;
        if (i < n) out[i] = static_cast<uint8_t>(A[k] >> (8 * j));
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// K8: out[i] = a[i] * b[i] in GF(2^m), uint8 storage, n elements; f is the
// irreducible polynomial of degree m as an integer (bit k: coefficient of x^k).
extern "C" int gf2m_swar_launch(const uint8_t* a, const uint8_t* b, uint8_t* out, long long n, int m,
                                unsigned f, void* stream) {
  if (n <= 0 || m < 2 || m > 8 || (f >> m) != 1u) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t r = f ^ (1u << m);
  const int deg_r = r ? 31 - __builtin_clz(r) : 0;
  const long long nvec = aligned16(a) && aligned16(b) && aligned16(out) ? n / 16 : 0;
  const long long blocks = ((n + 15) / 16 + THREADS - 1) / THREADS;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (m) {
    case 2: swar_kernel<2><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
    case 3: swar_kernel<3><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
    case 4: swar_kernel<4><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
    case 5: swar_kernel<5><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
    case 6: swar_kernel<6><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
    case 7: swar_kernel<7><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
    default: swar_kernel<8><<<grid, THREADS, 0, s>>>(a, b, out, n, nvec, r, deg_r); break;
  }
  return static_cast<int>(cudaGetLastError());
}
