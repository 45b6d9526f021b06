// The SWAR core of kernel K8, shared by csrc/gf2m_swar.cu (K8) and
// csrc/gf2m_chain.cu (K8-A, the power chain, and K8-B, the Berlekamp-Massey
// scan): GF(2^M) products, 2 <= M <= 8, of four uint8 elements packed in each
// 32-bit word, as galois_tpu/ops/_pallas/_elementwise.py:_swar_mul_core.
// The head of gf2m_swar.cu explains the algorithm.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

}  // namespace
