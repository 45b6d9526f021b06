// Kernel K15: a GF(2^m) product with a constant matrix, 2 <= m <= 16, as one
// GF(2)-linear map on int8 tensor cores.
//
// No Pallas kernel is replaced: the JAX package computes these products as a
// jnp.matmul of 0/1 bit planes outside any kernel (galois_tpu/ops/
// _binary_matmul.py), and the port ran them as torch passes around a float32
// GEMM (ops/_binary_matmul.py, kept for the public matmul, where both
// operands are data). Wrapper, layouts and plain torch version:
// ops/_gf2_linear.py. Its callers are the RS/BCH decoder's products with a
// constant of the code (codes/_decoder.py: syndromes, the erasure locator's
// interpolation, Chien, Forney's numerator and denominator).
//
// What it computes: out = x @ M over GF(2^m), x (rows, k) storage. Writing an
// element as its m bits, the product is GF(2)-linear in x's bits: with T the
// (k m, n m) 0/1 map whose block (j, c) is the matrix of multiplication by
// M[j, c], the output's bit string is parity(bits(x) @ T). T is built on the
// host once per code and device (linear_map, pack_map) and read here in the
// mma fragments' order.
//
// What bounds it on the H100: int8 operations for m = 8 (RS(255,223): each
// product some 68-71 G multiply-adds at B = 65536, 35-36 us at 1979 TOP/s;
// the storage moved is 2-17 MB), bytes for int64 storage (BCH(511,493):
// the (65536, 511) int64 words, 268 MB, 80 us at 3.35 TB/s). The design
// keeps every intermediate on the chip:
// - a CTA takes 32 rows a warp (up to 8 warps) and turns each row into its
//   bit string in shared memory: word s holds bits 32s..32s+31 of the
//   elements' m-bit concatenation (the bytes themselves for m = 8; else
//   each element ORed into its one or two words by a shared atomic);
// - each warp builds its mma A fragments from those words in registers: the
//   nibble at bit 16h + 4t of word s, spread into four 0/1 bytes by one
//   multiply; no plane is written anywhere;
// - T's B fragments stream from L2 through L1 (one coalesced 8-byte load a
//   lane and n8 tile), each used for two m16 tiles; all warps of a CTA walk
//   the same tiles in the same order;
// - mma.sync m16n8k32 s8 x s8 -> s32 into registers, 8 n8 tiles (64 output
//   bits) a pass; the sums are at most k m, and only their parity is kept;
// - the epilogue packs the parities into bytes of the output bit strings in
//   shared memory (two shuffles per two tiles), and the CTA writes its rows
//   of the (rows, n) storage as one contiguous, coalesced run.
// One launch a product; the wrapper allocates only the output.
//
// The entry points return cudaGetLastError() after the launch.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MT = 2;                  // m16 tiles a warp
constexpr int NT = 8;                  // n8 tiles a pass (ops/_gf2_linear.py: NT)
constexpr int WARP_ROWS = 16 * MT;     // rows a warp
constexpr int MAX_WARPS = 8;
constexpr int SMEM_TARGET = 112 * 1024;  // two CTAs an SM where the rows allow
constexpr int SMEM_MAX = 227 * 1024;
constexpr int RUN = 8;  // cells a thread of the staging walk loads at a time

// Bits 0..3 of v into bytes 0..3, each 0 or 1: the terms v, v << 7, v << 14
// and v << 21 do not overlap.
__device__ __forceinline__ uint32_t spread4(uint32_t v) { return ((v & 15u) * 0x00204081u) & 0x01010101u; }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An n8 tile's parities in this lane: byte 0 for row g (bits 2t, 2t + 1),
// byte 1 for row g + 8.
__device__ __forceinline__ uint32_t parities(const int (&c)[4], int t) {
  return ((c[0] & 1u) | (c[1] & 1u) << 1 | (c[2] & 1u) << 8 | (c[3] & 1u) << 9) << (2 * t);
}

// A walk over the (row, column) cells of a block n wide, step cells apart,
// with no division in the loop.
struct Walk {
  int r, c;
  const int dr, dc, n;
  __device__ Walk(int start, int step, int width)
      : r(start / width), c(start % width), dr(step / width), dc(step % width), n(width) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= n) c -= n, ++r;
  }
};

// Shared memory: the rows' bit strings, xstride words a row (odd, so that the
// eight rows a fragment load reads fall in eight banks), then the output bit
// strings, ostride bytes a row (at least 3 bytes past the tiles, which the
// last element's read may touch).
int x_stride(int ks) { return ks | 1; }
int o_stride(int groups) { return ((groups * NT + 6) / 4 | 1) * 4; }

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
    gf2_linear_kernel(const T* __restrict__ x, long long rows, long long ldx, int k, int m,
                      const uint2* __restrict__ frags, int ks, int groups, T* __restrict__ out, int n, int xstride,
                      int ostride) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x, bm = nthreads / 32 * WARP_ROWS;
  uint32_t* xs = smem;
  uint8_t* os = reinterpret_cast<uint8_t*>(smem + bm * xstride);
  const long long row0 = static_cast<long long>(blockIdx.x) * bm;
  const uint32_t mask = (1u << m) - 1;

  // 1. the rows' bit strings; rows past the end and bits past k m are 0. The
  // walks take RUN cells a thread at a time, their loads in flight together.
  const int warp = tid >> 5, lane = tid & 31;
  const int here = static_cast<int>(min(static_cast<long long>(bm), rows - row0));
  if (m == 8) {  // the bytes are the bit string
    uint8_t* xb = reinterpret_cast<uint8_t*>(xs);
    for (Walk q(tid, nthreads, 4 * ks); q.r < bm;) {
      uint8_t v[RUN];
      int at[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u, q.next()) {
        at[u] = q.r < bm ? 4 * q.r * xstride + q.c : -1;
        v[u] = q.r < here && q.c < k ? static_cast<uint8_t>(x[(row0 + q.r) * ldx + q.c]) : 0;
      }
#pragma unroll
      for (int u = 0; u < RUN; ++u)
        if (at[u] >= 0) xb[at[u]] = v[u];
    }
  } else {  // each element ORed into the one or two words its m bits touch
    for (int i = tid; i < bm * xstride; i += nthreads) xs[i] = 0;
    __syncthreads();
    for (Walk q(tid, nthreads, k); q.r < here;) {
      uint32_t v[RUN];
      int bit[RUN], row[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u, q.next()) {
        row[u] = q.r, bit[u] = q.c * m;
        v[u] = q.r < here ? static_cast<uint32_t>(x[(row0 + q.r) * ldx + q.c]) & mask : 0;
      }
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        if (row[u] >= here) break;
        const int off = bit[u] & 31;
        uint32_t* w = xs + row[u] * xstride + (bit[u] >> 5);
        atomicOr(w, v[u] << off);
        if (off + m > 32) atomicOr(w + 1, v[u] >> (32 - off));
      }
    }
  }
  __syncthreads();

  // 2. the products: a warp's 32 rows against every output bit, 64 a pass
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* xw = xs + (warp * WARP_ROWS + g) * xstride;
  uint8_t* ow = os + (warp * WARP_ROWS + g + 8 * (t & 1)) * ostride + (t >> 1);
  for (int grp = 0; grp < groups; ++grp) {
    int acc[MT][NT][4] = {};
    const uint2* fp = frags + static_cast<long long>(grp) * ks * NT * 32 + lane;
#pragma unroll 2
    for (int s = 0; s < ks; ++s) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint32_t lo = xw[16 * i * xstride + s], hi = xw[(16 * i + 8) * xstride + s];
        a[i][0] = spread4(lo >> (4 * t));
        a[i][1] = spread4(hi >> (4 * t));
        a[i][2] = spread4(lo >> (16 + 4 * t));
        a[i][3] = spread4(hi >> (16 + 4 * t));
      }
      uint2 b[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = __ldg(fp + (s * NT + j) * 32);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b[j].x, b[j].y);
      }
    }
    // two tiles' bytes in one word: row g and g + 8 of tile j, then of j + 1;
    // after the shuffles lane t stores byte t
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t v = parities(acc[i][j], t) | parities(acc[i][j + 1], t) << 16;
        v |= __shfl_xor_sync(0xffffffffu, v, 1);
        v |= __shfl_xor_sync(0xffffffffu, v, 2);
        ow[16 * i * ostride + grp * NT + j] = static_cast<uint8_t>(v >> (8 * t));
      }
    }
  }
  __syncthreads();

  // 3. the output bit strings into elements: the CTA's rows are one run of out
  T* o = out + row0 * n;
  int e = tid;
  for (Walk q(tid, nthreads, n); q.r < here; q.next(), e += nthreads) {
    const int bit = q.c * m;
    const uint8_t* p = os + q.r * ostride + (bit >> 3);
    const uint32_t w = p[0] | static_cast<uint32_t>(p[1]) << 8 | static_cast<uint32_t>(p[2]) << 16;
    o[e] = static_cast<T>((w >> (bit & 7)) & mask);
  }
}

template <typename T>
int launch(const T* x, long long rows, long long ldx, int k, int m, const void* frags, int ks, int groups, T* out,
           int n, void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || m < 2 || m > 16 || ks != (k * m + 31) / 32 ||
      groups != ((n * m + 7) / 8 + NT - 1) / NT || ldx < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int xstride = x_stride(ks), ostride = o_stride(groups);
  const int row_bytes = WARP_ROWS * (4 * xstride + ostride);
  const int warps = std::max(1, std::min(MAX_WARPS, SMEM_TARGET / row_bytes));
  const int smem = warps * row_bytes;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[64] = {};  // once a process, type and device: the attribute lasts
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(gf2_linear_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = true;
  }
  const long long bm = warps * WARP_ROWS, blocks = (rows + bm - 1) / bm;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gf2_linear_kernel<T><<<static_cast<unsigned>(blocks), warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, rows, ldx, k, m, static_cast<const uint2*>(frags), ks, groups, out, n, xstride, ostride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K15: out (rows, n), contiguous, = x @ M over GF(2^m); x (rows, k) at row
// stride ldx elements, inner stride 1; frags: pack_map's layout of M's map,
// (groups, ks, 8, 32) fragments of 8 bytes, ks = ceil(k m / 32), groups =
// ceil(ceil(n m / 8) / 8). uint8 storage (m <= 8) and int64 storage.
extern "C" int gf2_linear_u8(const uint8_t* x, long long rows, long long ldx, int k, int m, const void* frags, int ks,
                             int groups, uint8_t* out, int n, void* stream) {
  return launch(x, rows, ldx, k, m, frags, ks, groups, out, n, stream);
}

extern "C" int gf2_linear_i64(const int64_t* x, long long rows, long long ldx, int k, int m, const void* frags,
                              int ks, int groups, int64_t* out, int n, void* stream) {
  return launch(x, rows, ldx, k, m, frags, ks, groups, out, n, stream);
}
