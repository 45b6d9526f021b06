// The byte-slot carry-less ladder of the TPU's SWAR multiply
// (galois_tpu/ops/_pallas/_elementwise.py:_swar_nib_ladder) for K8-B's dot
// (csrc/gf2m_chain.cu, clmul_acc): products of four uint8 elements packed
// in each 32-bit word, each in its own byte slot. K8 itself now reads the
// field's tables (csrc/gf2m_swar.cu); its plain version keeps the SWAR form.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t ONES = 0x01010101u;  // bit 0 of every byte
constexpr uint32_t NIB = 0x0F0F0F0Fu;   // low nibble of every byte

// Carry-less x * (NBITS low bits of y) in byte slots; x holds at most 4-bit
// values per byte and NBITS <= 4, so every slot's product stays below 2^7.
// The 0/1 bit of each byte widens to a 0x7F byte mask as (bit << 7) - bit;
// no borrow crosses a slot.
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

}  // namespace
