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
// r = f ^ x^m reduce each slot from 2m - 1 bits to m. That core (nib_ladder,
// fold, mul_core) lives in gf2m_swar.cuh, which gf2m_chain.cu shares.
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

#include "gf2m_swar.cuh"

namespace {

constexpr int THREADS = 256;

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
