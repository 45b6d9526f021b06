// The field arithmetic of the scan kernels K12 and K13 (csrc/lfsr.cu): one
// element of an int-storage field up to 2^32 in a 32-bit register, for the
// fields those kernels serve (ops/_lfsr_scan.py::scan_supports):
//   - GF(p), p < 2^32 (GF(2) included): sums with one conditional subtract,
//     products as 64-bit products mod p, the reciprocal a^(p - 2);
//   - GF(2^m), 2 <= m <= 32: XOR sums; the carry-less 32 x 32-bit product in
//     a 64-bit register, then reduction by f from bit 2m - 2 down to bit m,
//     both branch-free; the reciprocal a^(2^m - 2);
//   - GF(p^m), p odd, m > 1, p^m <= 2^16: sums digit by digit in base p;
//     products and reciprocals through the field's EXP (2 (q - 1)) and LOG
//     (q) int32 tables, read through L1 (ops/_kernels.py::_Tables, one
//     table set per field and device; K3-K6 read the same cache).
// The table kernels' device functions (lookup.cuh, gf2m_chain.cu) are
// templated on m <= 16 and stage tables in shared memory for whole tensors;
// a scan reads a few elements a step, so it takes the products in
// registers and leaves the tables in L1. Odd p^m between 2^16 and 2^31 stay
// on the torch tick loop (ops/_lfsr_scan.py).

#pragma once

#include <stdint.h>

namespace field_scan {

enum Kind : int { PRIME = 0, BINARY = 1, TABLES = 2 };

struct Field {
  int kind;
  uint32_t p;       // the characteristic
  int m;            // the degree
  uint32_t f;       // BINARY: the modulus without x^m (f - x^m)
  uint32_t q1;      // the order - 1
  const int* exp;   // TABLES: EXP, 2 (q - 1) entries
  const int* log;   // TABLES: LOG, q entries
};

__device__ __forceinline__ uint32_t add(const Field& F, uint32_t a, uint32_t b) {
  if (F.kind == BINARY) return a ^ b;
  if (F.kind == PRIME) {
    const uint64_t s = static_cast<uint64_t>(a) + b;
    return static_cast<uint32_t>(s >= F.p ? s - F.p : s);
  }
  uint32_t r = 0, w = 1;
  for (int i = 0; i < F.m; ++i) {
    uint32_t d = a % F.p + b % F.p;
    a /= F.p;
    b /= F.p;
    r += (d >= F.p ? d - F.p : d) * w;
    w *= F.p;
  }
  return r;
}

__device__ __forceinline__ uint32_t neg(const Field& F, uint32_t a) {
  if (F.kind == BINARY) return a;
  if (F.kind == PRIME) return a ? F.p - a : 0u;
  uint32_t r = 0, w = 1;
  for (int i = 0; i < F.m; ++i) {
    const uint32_t d = a % F.p;
    a /= F.p;
    r += (d ? F.p - d : 0u) * w;
    w *= F.p;
  }
  return r;
}

__device__ __forceinline__ uint32_t sub(const Field& F, uint32_t a, uint32_t b) { return add(F, a, neg(F, b)); }

__device__ __forceinline__ uint32_t mul(const Field& F, uint32_t a, uint32_t b) {
  if (F.kind == PRIME) return static_cast<uint32_t>(static_cast<uint64_t>(a) * b % F.p);
  if (F.kind == BINARY) {
    uint64_t c = 0;
    for (int i = 0; i < F.m; ++i) c ^= (static_cast<uint64_t>(a) << i) & (0ull - ((b >> i) & 1u));
    const uint64_t full = static_cast<uint64_t>(F.f) | (1ull << F.m);
    for (int i = 2 * F.m - 2; i >= F.m; --i) c ^= (full << (i - F.m)) & (0ull - ((c >> i) & 1ull));
    return static_cast<uint32_t>(c);
  }
  if (a == 0 || b == 0) return 0;
  return static_cast<uint32_t>(__ldg(F.exp + __ldg(F.log + a) + __ldg(F.log + b)));
}

__device__ __forceinline__ uint32_t pow(const Field& F, uint32_t a, uint64_t e) {
  uint32_t r = 1;
  for (int i = 63; i >= 0; --i) {
    r = mul(F, r, r);
    if ((e >> i) & 1) r = mul(F, r, a);
  }
  return r;
}

// The reciprocal (0 for 0).
__device__ __forceinline__ uint32_t inv(const Field& F, uint32_t a) {
  if (a == 0) return 0;
  if (F.kind == TABLES) return static_cast<uint32_t>(__ldg(F.exp + F.q1 - __ldg(F.log + a)));
  return pow(F, a, static_cast<uint64_t>(F.q1) - 1);
}

}  // namespace field_scan
