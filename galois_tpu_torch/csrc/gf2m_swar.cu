// Kernel K8: GF(2^m) multiply, 2 <= m <= 8 (uint8 storage), by the field's
// byte rows in shared memory, broadcast operands read in place by stride.
//
// Replaces galois_tpu/ops/_pallas/_elementwise.py:447 gf2m_multiply_swar_pallas
// (pl.pallas_call :478). Wrapper and plain torch version:
// ops/_elementwise.py::gf2m_multiply_swar. It is the kernel behind
// BinaryExtOps.multiply for GF(2^m), 2 <= m <= 8, so every GF(2^8) product
// of the port runs on it: the headline x * y and the Reed-Solomon decoder's
// polynomial products, formal derivative and Forney products.
//
// What it computes: a * b = EXP[LOG a + LOG b], 0 where a or b is 0, the map
// of the TPU kernel's SWAR algorithm (its plain version here stays that
// algorithm). The TPU has no gather worth the name, so its kernel built the
// carry-less products in byte slots and folded them by f, some 40 32-bit
// operations a product at m = 8; the H100's shared memory serves a table
// read a lane and clock, so this kernel reads pack_tables' 'bytes' rows
// (ops/_lookup.py: byte 0 LOG[r], byte 1 EXP[r], 2(q - 1) rows, built once
// per field and device), copied once per bank as K3 stages them
// (lookup.cuh), so a warp's 32 reads never conflict.
//
// What bounds it on the H100: HBM bytes, then the shared-memory wavefronts.
// A product moves 3 bytes when both operands are whole tensors (2^24: 50.3
// MB, 0.0150 ms at 3.35 TB/s) against three table reads (1.6 M wavefronts
// at 2^24, 0.006 ms over 132 SMs at one a clock). A broadcast operand is
// read once, by stride: the RS decoder's (65536, 32, 33) outer product of
// (65536, 1, 33) and (65536, 32, 1) moves 73.5 MB (0.022 ms), where
// materializing both operands first wrote and read another 277 MB.
//
// Design:
// - the wrapper merges the output's axes into at most three, (n0, n1, n2),
//   with an element stride per operand and axis (ops/_elementwise.py,
//   _merged_axes); layouts of more axes are materialized there;
// - an operand laid out as the output (or of one element) is a 16-byte
//   evict-first stream, funnel-shifted where a view is off alignment
//   (lookup.cuh's Stream); with both so, the pass is K3's;
// - otherwise each thread takes 16 consecutive outputs a step (one 16-byte
//   store) and a grid-stride pass walks the coordinates by adds
//   (lookup.cuh's Coord); where n2 >= 16 a run of 16 crosses at most one
//   end of the inner axis, so an operand of inner stride 1 is read from two
//   segments, and an operand that is constant along the inner axis (stride
//   0: the outer product's b, the RS decoder's (B, 1) column) is read, and
//   its LOG looked up, once a segment: two reads a run and not sixteen.
//   Any other stride, and an inner axis below 16, steps the coordinates
//   element by element;
// - one launch of at most as many blocks as the SMs hold at once, the
//   table staged once per block.
// Measured on an H100 80GB HBM3 at its 700 W limit (chip_smoke.py,
// scripts/power_timing.py; PERF.md): 0.017 ms at 2^24, where the TPU
// kernel's SWAR form took 0.033 ms; the outer product 0.087 ms a wrapper
// call, where materializing both operands and the SWAR form took 0.36 ms.
// The strided pass is short of its bound: some 13 instructions an output
// in the inner loop (SASS), half of them the two table reads and their
// addresses.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "lookup.cuh"

namespace {

// How an operand is read: FLAT, a stream laid out as the output (or one
// element); CONST_ROW, constant along an inner axis of n2 >= 16 (two reads
// a run); SEG1, inner stride 1 with n2 >= 16 (two segments a run); ELEM,
// element by element.
enum { FLAT = 0, CONST_ROW = 1, SEG1 = 2, ELEM = 3 };

struct Operand {
  const uint8_t* p;
  Strides st;
  int mode;
  bool one;  // FLAT: a single element
};

constexpr int RUN = 16;

// The run's 16 elements of a FLAT, SEG1 or ELEM operand, each in a
// register (x) and four to a word (X). o0: its offset at the run's first
// element; o1: at the next row's first element (used where w < RUN); w: the
// run's elements before the end of the inner axis; c: the first element's
// coordinates. Within a run the arithmetic is 32-bit: SEG1's loads are one
// of two pointers plus the element's place, an immediate.
__device__ __forceinline__ void run_elements(const Operand& A, const Stream& S, long long v, long long o0,
                                             long long o1, int w, Coord c, long long i0, const Axes& ax,
                                             uint32_t (&x)[RUN], uint32_t (&X)[4]) {
  if (A.mode == FLAT) {
    const uint4 ch = S.chunk(v);
    X[0] = ch.x, X[1] = ch.y, X[2] = ch.z, X[3] = ch.w;
#pragma unroll
    for (int j = 0; j < RUN; ++j) x[j] = (X[j >> 2] >> (8 * (j & 3))) & 0xFF;
    return;
  }
  // SEG1: element j of the run is p0[j] for j < w, else p1[j]; two
  // predicated loads, not a select of their addresses
  if (A.mode == SEG1) {
    const uint8_t* p0 = A.p + o0;
    const uint8_t* p1 = A.p + (o1 - w);
    asm("" : "+l"(p0), "+l"(p1));  // two registers: the compiler would add A.p again at every load
#pragma unroll
    for (int j = 0; j < RUN; ++j) x[j] = j < w ? __ldg(p0 + j) : __ldg(p1 + j);
  } else {
    const long long n12 = ax.n1 * ax.n2;
    long long c0 = i0 / n12, c1 = c.c1, c2 = c.c2;
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      x[j] = __ldg(A.p + c0 * A.st.s0 + c1 * A.st.s1 + c2 * A.st.s2);
      if (++c2 == ax.n2) {
        c2 = 0;
        if (++c1 == ax.n1) c1 = 0, ++c0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) X[k] = pack_bytes(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

// a and b as the launcher merged them; out (n elements) 16-byte aligned;
// rows_g: pack_tables' 2(q - 1) byte rows. a's mode is not CONST_ROW (the
// launcher swaps the operands).
__global__ void __launch_bounds__(BYTE_THREADS)
mul_kernel(Operand a, Operand b, uint8_t* __restrict__ out, Axes ax, const uint32_t* __restrict__ rows_g, int rows) {
  extern __shared__ uint4 s_rows[];  // rows x 32 lanes x 4 bytes
  stage_byte_rows(s_rows, rows_g, rows, BYTE_THREADS);
  const uint8_t* col = reinterpret_cast<const uint8_t*>(s_rows) + 4 * (threadIdx.x & 31);
  const long long tid = static_cast<long long>(blockIdx.x) * BYTE_THREADS + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * BYTE_THREADS;
  const uint32_t ar = (a.one ? __ldg(a.p) : 0u) * 0x01010101u, br = (b.one ? __ldg(b.p) : 0u) * 0x01010101u;
  const Stream SA(a.p, a.one, make_uint4(ar, ar, ar, ar)), SB(b.p, b.one, make_uint4(br, br, br, br));
  const long long nv = ax.n >> 4;
  if (a.mode == FLAT && b.mode == FLAT) {  // K3's pass
    stream_pass(SA, SB, reinterpret_cast<uint4*>(out), nv, tid, nthreads, [col](uint4 x, uint4 y) {
      return make_uint4(word_op<OP_MUL>(col, x.x, y.x), word_op<OP_MUL>(col, x.y, y.y),
                        word_op<OP_MUL>(col, x.z, y.z), word_op<OP_MUL>(col, x.w, y.w));
    });
  } else if (tid < nv) {
    Coord c(RUN * tid, ax);
    long long oa = c.offset(RUN * tid, a.st, ax), ob = c.offset(RUN * tid, b.st, ax);
    for (long long v = tid; v < nv; v += nthreads) {
      const long long i0 = RUN * v;
      const int w = ax.n2 - c.c2 < RUN ? static_cast<int>(ax.n2 - c.c2) : RUN;
      // the offsets of the next row's first element: (c1 + 1, 0), or (c0 + 1, 0, 0)
      const bool last = c.c1 + 1 == ax.n1;
      const long long na = w < RUN ? oa + a.st.s1 - c.c2 * a.st.s2 + (last ? a.st.w1 : 0) : oa;
      const long long nb = w < RUN ? ob + b.st.s1 - c.c2 * b.st.s2 + (last ? b.st.w1 : 0) : ob;
      uint32_t x[RUN], X[4], Y[4], r[RUN];
      run_elements(a, SA, v, oa, na, w, c, i0, ax, x, X);
      if (b.mode == CONST_ROW) {
        const uint32_t y0 = __ldg(b.p + ob), y1 = __ldg(b.p + nb);
        // EXP's column from b's row on: EXP[LOG a + LOG b] is e0[LOG a * ROW] (or e1's)
        const uint8_t* e0 = col + (col[y0 * ROW] * ROW + 1);
        const uint8_t* e1 = col + (col[y1 * ROW] * ROW + 1);
        const uint32_t z0 = y0 ? ~0u : 0u, z1 = y1 ? ~0u : 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // bytes of word k before the end of the row take y0, the rest y1
          const int kw = w - 4 * k;
          const uint32_t first = kw >= 4 ? ~0u : kw <= 0 ? 0u : (1u << (8 * kw)) - 1;
          Y[k] = (first & z0) | (~first & z1);
        }
#pragma unroll
        for (int j = 0; j < RUN; ++j) r[j] = (j < w ? e0 : e1)[col[x[j] * ROW] * ROW];
#pragma unroll
        for (int k = 0; k < 4; ++k) X[k] = nonzero_bytes(X[k]) & Y[k];
      } else {
        uint32_t y[RUN];
        run_elements(b, SB, v, ob, nb, w, c, i0, ax, y, Y);
#pragma unroll
        for (int j = 0; j < RUN; ++j) r[j] = col[(col[x[j] * ROW] + col[y[j] * ROW]) * ROW + 1];
#pragma unroll
        for (int k = 0; k < 4; ++k) X[k] = nonzero_bytes(X[k]) & nonzero_bytes(Y[k]);
      }
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = pack_bytes(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]) & X[k];
      __stcs(reinterpret_cast<uint4*>(out) + v, make_uint4(o[0], o[1], o[2], o[3]));
      bool carry2, carry1;
      c.step(ax, carry2, carry1);
      advance(oa, a.st, carry2, carry1);
      advance(ob, b.st, carry2, carry1);
    }
  }
  for (long long i = (nv << 4) + tid; i < ax.n; i += nthreads) {  // the ragged tail
    const Coord c(i, ax);
    const uint32_t x = __ldg(a.p + c.offset(i, a.st, ax)), y = __ldg(b.p + c.offset(i, b.st, ax));
    out[i] = static_cast<uint8_t>(x == 0 || y == 0 ? 0 : byte_op<OP_MUL>(col, x, y));
  }
}

int mode(long long s0, long long s1, long long s2, long long n0, long long n1, long long n2) {
  if (flat_unit(s0, s1, s2, n0, n1, n2) >= 0) return FLAT;
  if (n2 < RUN) return ELEM;
  return s2 == 0 ? CONST_ROW : s2 == 1 ? SEG1 : ELEM;
}

}  // namespace

// K8: out = a * b in GF(2^m), 2 <= m <= 8, uint8 storage; out holds n
// elements, (n / (n1 n2), n1, n2), 16-byte aligned; a and b are read at
// element strides (s0, s1, s2) along those axes. rows: pack_tables' 'bytes'
// table of the field, 2(2^m - 1) int32 words.
extern "C" int gf2m_swar_launch(const uint8_t* a, long long as0, long long as1, long long as2, const uint8_t* b,
                                long long bs0, long long bs1, long long bs2, uint8_t* out, long long n, long long n1,
                                long long n2, int m, const uint32_t* rows, void* stream) {
  if (n <= 0 || n1 <= 0 || n2 <= 0 || n % (n1 * n2) || m < 2 || m > 8 || !aligned16(out) || !rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n0 = n / (n1 * n2);
  int a_mode = mode(as0, as1, as2, n0, n1, n2), b_mode = mode(bs0, bs1, bs2, n0, n1, n2);
  if (a_mode == CONST_ROW && b_mode != CONST_ROW) {  // the product commutes: the constant one reads as b
    std::swap(a, b), std::swap(as0, bs0), std::swap(as1, bs1), std::swap(as2, bs2);
    std::swap(a_mode, b_mode);
  }
  if (a_mode == CONST_ROW) a_mode = ELEM;  // both constant along the inner axis
  const int rows_n = 2 * ((1 << m) - 1), smem = rows_n * static_cast<int>(ROW);
  unsigned blocks = 0;
  cudaError_t err = persistent_grid(mul_kernel, BYTE_THREADS, smem, n / RUN + 1, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long step = static_cast<long long>(RUN) * blocks * BYTE_THREADS;
  const Axes ax = make_axes(n, n1, n2, step);
  const Operand A{a, make_strides(as0, as1, as2, ax, step), a_mode, flat_unit(as0, as1, as2, n0, n1, n2) == 0};
  const Operand B{b, make_strides(bs0, bs1, bs2, ax, step), b_mode, flat_unit(bs0, bs1, bs2, n0, n1, n2) == 0};
  mul_kernel<<<blocks, BYTE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(A, B, out, ax, rows, rows_n);
  return static_cast<int>(cudaGetLastError());
}
