// The field arithmetic of the scan kernels K12 and K13 (csrc/lfsr.cu): one
// element of an int-storage field up to 2^32 in a 32-bit register, fixed at
// compile time by the kind (a template parameter of every scan kernel, so
// that no inner loop branches on it), for the fields those kernels serve
// (ops/_lfsr_scan.py::scan_supports):
//   - GF2: GF(2), the sum an XOR and the product an AND;
//   - PRIME: GF(p), 2 < p < 2^32: sums with one conditional subtract,
//     products by Barrett's reduction with mu = floor(2^64 / p) from the
//     host (a 64 x 64-bit high product and one conditional subtract; no
//     division), the reciprocal a^(p - 2);
//   - BINARY: GF(2^m), 17 <= m <= 32: XOR sums; the carry-less 32 x 32-bit
//     product in a 64-bit register, then reduction by f from bit 2m - 2 down
//     to bit m, both branch-free; the reciprocal a^(2^m - 2);
//   - BINTAB and ODDTAB: GF(2^m), 2 <= m <= 16, and GF(p^m), p odd, m > 1,
//     p^m <= 2^16: products and reciprocals through the field's LOG (q) and
//     EXP int32 tables (ops/_kernels.py::_Tables, one table set per field
//     and device; K3-K6 read the same cache), EXP extended by the wrapper
//     with 2 (q - 1) + 1 zeros: 0's LOG is taken as sent = 2 (q - 1), so a
//     product is EXP[LOG a + LOG b] with no branch, 0 wherever a factor is
//     0. The tables are read through L1 (K12's block form stages EXP in
//     shared memory for q <= 1024); BINTAB sums by XOR, ODDTAB digit by
//     digit in base p (quotients by p as a high product with
//     ceil(2^32 / p) from the host, exact below 2^16).
// The block form of K12 multiplies state elements by constants: prep()
// gives the form a factor takes there (its LOG for the table kinds, sent
// for 0; itself otherwise) and mulp() multiplies two such forms, so that a
// table product is one EXP read. The table kernels' device functions
// (lookup.cuh, gf2m_chain.cu) are templated on m <= 16 and stage tables in
// shared memory for whole tensors; a scan reads a few elements a step, so it
// leaves the tables in L1. Odd p^m between 2^16 and 2^31 stay on the torch
// tick loop (ops/_lfsr_scan.py). What bounds the scans is the latency of
// each step's chain (csrc/lfsr.cu), to which a product adds: an AND over
// GF(2), about a dozen dependent integer operations by Barrett, one or two
// L1 or shared-memory reads through the tables, about 4m over GF(2^m > 16).

#pragma once

#include <stdint.h>

namespace field_scan {

enum Kind : int { GF2 = 0, PRIME = 1, BINARY = 2, BINTAB = 3, ODDTAB = 4 };

struct Field {
  uint32_t p;              // the characteristic
  int m;                   // the degree
  uint32_t f;              // BINARY: the modulus without x^m (f - x^m)
  uint32_t q1;             // the order - 1
  unsigned long long mu;   // PRIME: floor(2^64 / p)
  uint32_t pinv;           // ODDTAB: ceil(2^32 / p)
  uint32_t sent;           // table kinds: 2 (q - 1), the LOG taken for 0
  const int* exp;          // table kinds: EXP, then zeros: 4 (q - 1) + 1 entries
  const int* log;          // table kinds: LOG, q entries
};

template <int K>
struct Arith;

template <>
struct Arith<GF2> {
  static __device__ __forceinline__ uint32_t add(const Field&, uint32_t a, uint32_t b) { return a ^ b; }
  static __device__ __forceinline__ uint32_t sub(const Field&, uint32_t a, uint32_t b) { return a ^ b; }
  static __device__ __forceinline__ uint32_t mul(const Field&, uint32_t a, uint32_t b) { return a & b; }
  static __device__ __forceinline__ uint32_t inv(const Field&, uint32_t a) { return a; }
  static __device__ __forceinline__ uint32_t prep(const Field&, uint32_t a) { return a; }
  static __device__ __forceinline__ uint32_t mulp(const Field&, uint32_t a, uint32_t b) { return a & b; }
};

template <>
struct Arith<PRIME> {
  static __device__ __forceinline__ uint32_t add(const Field& F, uint32_t a, uint32_t b) {
    const uint64_t s = static_cast<uint64_t>(a) + b;
    return static_cast<uint32_t>(s >= F.p ? s - F.p : s);
  }
  static __device__ __forceinline__ uint32_t sub(const Field& F, uint32_t a, uint32_t b) {
    return a >= b ? a - b : static_cast<uint32_t>(static_cast<uint64_t>(a) + F.p - b);
  }
  // x = a b < p^2 < 2^64; q = floor(x mu / 2^64) is floor(x / p) or one less
  static __device__ __forceinline__ uint32_t mul(const Field& F, uint32_t a, uint32_t b) {
    const uint64_t x = static_cast<uint64_t>(a) * b;
    const uint64_t r = x - __umul64hi(x, F.mu) * F.p;
    return static_cast<uint32_t>(r >= F.p ? r - F.p : r);
  }
  static __device__ __forceinline__ uint32_t inv(const Field& F, uint32_t a) {
    const uint32_t e = F.p - 2;
    uint32_t r = 1;
    for (int i = 31 - __clz(static_cast<int>(e)); i >= 0; --i) {
      r = mul(F, r, r);
      if ((e >> i) & 1) r = mul(F, r, a);
    }
    return r;
  }
  static __device__ __forceinline__ uint32_t prep(const Field&, uint32_t a) { return a; }
  static __device__ __forceinline__ uint32_t mulp(const Field& F, uint32_t a, uint32_t b) { return mul(F, a, b); }
};

template <>
struct Arith<BINARY> {
  static __device__ __forceinline__ uint32_t add(const Field&, uint32_t a, uint32_t b) { return a ^ b; }
  static __device__ __forceinline__ uint32_t sub(const Field&, uint32_t a, uint32_t b) { return a ^ b; }
  static __device__ __forceinline__ uint32_t mul(const Field& F, uint32_t a, uint32_t b) {
    uint64_t c = 0;
    for (int i = 0; i < F.m; ++i) c ^= (static_cast<uint64_t>(a) << i) & (0ull - ((b >> i) & 1u));
    const uint64_t full = static_cast<uint64_t>(F.f) | (1ull << F.m);
    for (int i = 2 * F.m - 2; i >= F.m; --i) c ^= (full << (i - F.m)) & (0ull - ((c >> i) & 1ull));
    return static_cast<uint32_t>(c);
  }
  static __device__ __forceinline__ uint32_t inv(const Field& F, uint32_t a) {
    uint32_t r = 1;  // a^(2^m - 2): m - 1 ones, then a zero
    for (int i = 0; i < F.m; ++i) {
      r = mul(F, r, r);
      if (i < F.m - 1) r = mul(F, r, a);
    }
    return r;
  }
  static __device__ __forceinline__ uint32_t prep(const Field&, uint32_t a) { return a; }
  static __device__ __forceinline__ uint32_t mulp(const Field& F, uint32_t a, uint32_t b) { return mul(F, a, b); }
};

// The table kinds' products, reciprocals and prepared forms; EXP is read
// by generic loads, as it may lie in shared memory.
struct Tables {
  static __device__ __forceinline__ uint32_t prep(const Field& F, uint32_t a) {
    const uint32_t l = static_cast<uint32_t>(__ldg(F.log + a));
    return a ? l : F.sent;
  }
  static __device__ __forceinline__ uint32_t mulp(const Field& F, uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(F.exp[a + b]);
  }
  static __device__ __forceinline__ uint32_t mul(const Field& F, uint32_t a, uint32_t b) {
    return mulp(F, prep(F, a), prep(F, b));
  }
  static __device__ __forceinline__ uint32_t inv(const Field& F, uint32_t a) {
    return a ? static_cast<uint32_t>(F.exp[F.q1 - __ldg(F.log + a)]) : 0u;
  }
};

template <>
struct Arith<BINTAB> : Tables {
  static __device__ __forceinline__ uint32_t add(const Field&, uint32_t a, uint32_t b) { return a ^ b; }
  static __device__ __forceinline__ uint32_t sub(const Field&, uint32_t a, uint32_t b) { return a ^ b; }
};

template <>
struct Arith<ODDTAB> : Tables {
  // digit by digit in base p: sign +1 adds, -1 subtracts
  template <int SIGN>
  static __device__ __forceinline__ uint32_t digits(const Field& F, uint32_t a, uint32_t b) {
    uint32_t r = 0, w = 1;
    for (int i = 0; i < F.m; ++i) {
      const uint32_t qa = __umulhi(a, F.pinv), qb = __umulhi(b, F.pinv);
      const uint32_t da = a - qa * F.p, db = b - qb * F.p;
      uint32_t d = SIGN > 0 ? da + db : da + F.p - db;
      if (d >= F.p) d -= F.p;
      r += d * w;
      w *= F.p;
      a = qa;
      b = qb;
    }
    return r;
  }
  static __device__ __forceinline__ uint32_t add(const Field& F, uint32_t a, uint32_t b) { return digits<1>(F, a, b); }
  static __device__ __forceinline__ uint32_t sub(const Field& F, uint32_t a, uint32_t b) { return digits<-1>(F, a, b); }
};

}  // namespace field_scan
