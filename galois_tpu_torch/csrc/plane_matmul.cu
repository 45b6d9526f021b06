// Kernels K1 and K2: the NTT's two fused balanced-plane prime matmuls.
//
// Replaces galois_tpu/ops/_pallas/_plane_matmul.py:
//   K1 plane_matmul_data_right (:323; body _kernel_data_right :219):
//        out = (A @ X) mod p, optionally * twiddle mod p   (NTT side 1)
//   K2 plane_matmul_data_left  (:261; body _kernel_data_left :179):
//        out = (X @ B) mod p, optionally written transposed (NTT side 2)
// A and B are static DFT tables given as their n balanced base-256 int8
// planes, raw (n, rows, cols) as balanced_planes_np makes them. X is int64
// residue data in [0, p), p < 2^32. The batch is blockIdx.z.
//
// Per 64 x 32 output tile a block (1) extracts the data operand's n
// balanced int8 planes of each 64-deep K-chunk into shared memory, (2) sums
// the n^2 plane-pair products into 2n - 1 int32 diagonal accumulators D_s
// (s = i + j) with int8 tensor-core MMAs (mma.sync m16n8k32 s8.s8.s32),
// and (3) folds sum_s D_s * (2^(8s) mod p) mod p in 64-bit integer
// arithmetic, then applies the twiddle or the transposed store.
//
// What bounds it on the H100: int8 multiply-accumulate throughput. A side
// costs n^2 * M*K*N int8 MACs against about (M*K + K*N) * 8 bytes of reads,
// so at the NTT's 4096-wide sides it is compute bound by a wide margin, and
// the tensor cores are where that compute is. The 2n - 1 diagonal
// accumulators multiply the register cost of an output tile, so each warp
// keeps a 16 x 16 tile (1 x 2 MMA tiles, 8(2n - 1) accumulator registers)
// and a block of 8 warps a 64 x 32 tile; two blocks fit on an SM, so one
// block's loads overlap the other's MMAs. wgmma and TMA are the next step.
//
// What differs from the TPU kernel, and why:
// - The TPU version caches the data planes of the whole K extent in VMEM
//   (4 MB at K = 4096). Here each K-chunk is extracted into shared memory
//   inside the block's K loop: n * (64 + 32) * 80 bytes per block (38 KB at
//   n = 5), independent of K.
// - The balanced digits come in one step: with bias = 0x80...80 (n bytes),
//   the bytes of (x' + bias) ^ bias are the n digits of the symmetric
//   residue x' as int8 (the representation is unique, and the plane count
//   keeps x' + bias in [0, 256^n)).
// - No 256/512 tile constraint: ragged edges are masked (zero planes).
// - The epilogue uses 64-bit integer Barrett mulmod (residues < p < 2^32,
//   so every product fits unsigned long long), not the TPU's f32 pipeline.
//
// Exactness: each D_s sums at most n plane-pair products of K terms of
// magnitude <= 128^2, so the caller's gate n * K * 128^2 < min(2^31, p)
// keeps D_s exact in int32 (the s8 MMA accumulates without saturation) and
// |D_s| < p.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 32;       // output columns per block
constexpr int BK = 64;       // contraction elements per shared-memory stage
constexpr int KW = BK / 4;   // packed int32 words (4 int8 digits) per stage row
constexpr int KWP = KW + 4;  // padded row stride: conflict-free fragment loads
constexpr int WM = 16;       // rows per warp
constexpr int WN = 16;       // columns per warp
constexpr int MT = WM / 16;  // m16n8k32 MMA tiles per warp, along rows
constexpr int NT = WN / 8;   // and along columns
constexpr int THREADS = 32 * (BM / WM) * (BN / WN);  // 8 warps, 4 x 2
// Two blocks (16 warps) per SM: the registers are cut to 128 a thread so
// that one block's K-chunk loads and digit extraction overlap the other's
// MMAs. On the H100 this tile beat 32 x 16 warp tiles at 2 or 3 blocks per
// SM and a 64 x 64 block tile (chip sweep at the NTT's 4096-wide sides).
constexpr int MIN_BLOCKS = 2;

// The n balanced base-256 digits of the symmetric residue of v in [0, p),
// as int8 bytes of the result, lowest digit in the lowest byte.
// Up to four planes fit 32-bit arithmetic: the symmetric residue's two's
// complement wraps, and x' + bias < 2^32 is exact modulo 2^32.
template <int NP>
__device__ __forceinline__ unsigned long long balanced_digits(long long v, long long p) {
  constexpr unsigned long long bias = 0x8080808080ULL >> (8 * (5 - NP));
  if constexpr (NP <= 4) {
    const unsigned x = static_cast<unsigned>(v), up = static_cast<unsigned>(p);
    const unsigned s = x > up / 2 ? x - up : x;
    return (s + static_cast<unsigned>(bias)) ^ static_cast<unsigned>(bias);
  } else {
    const long long s = v > p / 2 ? v - p : v;
    return static_cast<unsigned long long>(s + static_cast<long long>(bias)) ^ bias;
  }
}

// Transposes the digits of four consecutive-k elements into NP words:
// word i holds digit i of each element, lowest k in the lowest byte.
template <int NP>
__device__ __forceinline__ void pack_planes(const unsigned long long (&d)[4], unsigned (&words)[NP]) {
  const unsigned d0 = static_cast<unsigned>(d[0]), d1 = static_cast<unsigned>(d[1]);
  const unsigned d2 = static_cast<unsigned>(d[2]), d3 = static_cast<unsigned>(d[3]);
  const unsigned lo01 = __byte_perm(d0, d1, 0x5140), hi01 = __byte_perm(d0, d1, 0x7362);
  const unsigned lo23 = __byte_perm(d2, d3, 0x5140), hi23 = __byte_perm(d2, d3, 0x7362);
  const unsigned w[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                         __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
  for (int i = 0; i < (NP < 4 ? NP : 4); ++i) words[i] = w[i];
  if constexpr (NP == 5)
    words[4] = static_cast<unsigned>((d[0] >> 32) & 0xFF) | static_cast<unsigned>((d[1] >> 32) & 0xFF) << 8 |
               static_cast<unsigned>((d[2] >> 32) & 0xFF) << 16 | static_cast<unsigned>((d[3] >> 32) & 0xFF) << 24;
}

// (a * b) mod p for a, b < p < 2^32 by Barrett reduction with
// mu = floor((2^64 - 1) / p): the quotient estimate is low by at most 2, so
// two conditional subtractions finish it (a 64-bit `%` costs far more).
__device__ __forceinline__ unsigned long long mulmod(unsigned long long a, unsigned long long b,
                                                     unsigned long long p, unsigned long long mu) {
  const unsigned long long x = a * b;
  unsigned long long r = x - __umul64hi(x, mu) * p;
  if (r >= p) r -= p;
  if (r >= p) r -= p;
  return r;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// DATA_LEFT = false (K1): lhs = (NP, M, K) int8 table planes, rhs = (B, K, N) int64 data.
// DATA_LEFT = true  (K2): lhs = (B, M, K) int64 data, rhs = (NP, K, N) int8 table planes.
// out = (B, M, N) int64, or (B, N, M) when transpose_out.
template <int NP, bool DATA_LEFT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
plane_matmul_kernel(const void* __restrict__ lhs, const void* __restrict__ rhs,
                    const long long* __restrict__ twiddle, long long* __restrict__ out,
                    int M, int K, int N, long long p, int transpose_out) {
  // Row r of a stage holds the BK digits of one output row (As) or one
  // output column (Bs) of one plane, packed four to an int32 word along k:
  // the row-major A and column-major B fragments of the MMA read it as is.
  __shared__ unsigned As[NP][BM][KWP];
  __shared__ unsigned Bs[NP][BN][KWP];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;  // MMA fragment group and thread-in-group
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long b = blockIdx.z;
  // K1's table rows can be read as whole int32 words when they are aligned.
  const bool k_words = K % 4 == 0 && reinterpret_cast<uintptr_t>(lhs) % 4 == 0;

  int acc[2 * NP - 1][MT][NT][4];
#pragma unroll
  for (int s = 0; s < 2 * NP - 1; ++s)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][mt][nt][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (DATA_LEFT) {
      // data rows (m, k contiguous): 8 threads cover one row's 64 k.
      const long long* X = static_cast<const long long*>(lhs) + b * M * K;
      for (int idx = tid; idx < BM * KW; idx += THREADS) {
        const int w = idx % KW, r = idx / KW;
        const int m = m0 + r, k = k0 + 4 * w;
        unsigned long long d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = balanced_digits<NP>(m < M && k + e < K ? X[static_cast<long long>(m) * K + k + e] : 0, p);
        unsigned words[NP];
        pack_planes<NP>(d, words);
#pragma unroll
        for (int i = 0; i < NP; ++i) As[i][r][w] = words[i];
      }
      // table planes (k, n contiguous): gather four k per word.
      const int8_t* P = static_cast<const int8_t*>(rhs);
      for (int idx = tid; idx < NP * BN * KW; idx += THREADS) {
        const int c = idx % BN, w = (idx / BN) % KW, j = idx / (BN * KW);
        const int n = n0 + c, k = k0 + 4 * w;
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n < N && k + e < K)
            word |= static_cast<unsigned>(static_cast<uint8_t>(P[(static_cast<long long>(j) * K + k + e) * N + n])) << (8 * e);
        Bs[j][c][w] = word;
      }
    } else {
      // table planes (m, k contiguous): whole int32 words when aligned.
      const int8_t* P = static_cast<const int8_t*>(lhs);
      for (int idx = tid; idx < NP * BM * KW; idx += THREADS) {
        const int w = idx % KW, r = (idx / KW) % BM, i = idx / (KW * BM);
        const int m = m0 + r, k = k0 + 4 * w;
        const long long base = (static_cast<long long>(i) * M + m) * K + k;
        unsigned word = 0;
        if (m < M && k < K) {
          if (k_words) {
            word = *reinterpret_cast<const unsigned*>(P + base);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k + e < K) word |= static_cast<unsigned>(static_cast<uint8_t>(P[base + e])) << (8 * e);
          }
        }
        As[i][r][w] = word;
      }
      // data columns (k, n contiguous): neighbouring threads read neighbouring n.
      const long long* X = static_cast<const long long*>(rhs) + b * K * N;
      for (int idx = tid; idx < BN * KW; idx += THREADS) {
        const int c = idx % BN, w = idx / BN;
        const int n = n0 + c, k = k0 + 4 * w;
        unsigned long long d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = balanced_digits<NP>(n < N && k + e < K ? X[static_cast<long long>(k + e) * N + n] : 0, p);
        unsigned words[NP];
        pack_planes<NP>(d, words);
#pragma unroll
        for (int j = 0; j < NP; ++j) Bs[j][c][w] = words[j];
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < KW; ks += 8) {  // one m16n8k32 step = 8 words of k
      unsigned bf[NP][NT][2];
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned* row = Bs[j][wn0 + nt * 8 + g];
          bf[j][nt][0] = row[ks + t];
          bf[j][nt][1] = row[ks + t + 4];
        }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        unsigned af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned* lo = As[i][wm0 + mt * 16 + g];
          const unsigned* hi = As[i][wm0 + mt * 16 + g + 8];
          af[mt][0] = lo[ks + t];
          af[mt][1] = hi[ks + t];
          af[mt][2] = lo[ks + t + 4];
          af[mt][3] = hi[ks + t + 4];
        }
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_s8(acc[i + j][mt][nt], af[mt], bf[j][nt]);
      }
    }
    __syncthreads();
  }

  const unsigned long long up = static_cast<unsigned long long>(p);
  const unsigned long long mu = ~0ULL / up;
  unsigned long long w[2 * NP - 1];  // 2^(8s) mod p
  w[0] = 1;
#pragma unroll
  for (int s = 1; s < 2 * NP - 1; ++s) w[s] = mulmod(w[s - 1], 256, up, mu);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn0 + nt * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        unsigned long long res = 0;
#pragma unroll
        for (int s = 0; s < 2 * NP - 1; ++s) {
          const long long d = acc[s][mt][nt][e];
          const unsigned long long u = static_cast<unsigned long long>(d < 0 ? d + p : d);
          res += mulmod(u, w[s], up, mu);
          if (res >= up) res -= up;
        }
        if (twiddle != nullptr)
          res = mulmod(res, static_cast<unsigned long long>(twiddle[static_cast<long long>(m) * N + n]), up, mu);
        const long long o = transpose_out ? (b * N + n) * M + m : (b * M + m) * N + n;
        out[o] = static_cast<long long>(res);
      }
}

template <bool DATA_LEFT>
int launch(const void* lhs, const void* rhs, const long long* twiddle, long long* out, int batch,
           int M, int K, int N, int n_planes, long long p, int transpose_out, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 3:
      plane_matmul_kernel<3, DATA_LEFT><<<grid, THREADS, 0, s>>>(lhs, rhs, twiddle, out, M, K, N, p, transpose_out);
      break;
    case 4:
      plane_matmul_kernel<4, DATA_LEFT><<<grid, THREADS, 0, s>>>(lhs, rhs, twiddle, out, M, K, N, p, transpose_out);
      break;
    case 5:
      plane_matmul_kernel<5, DATA_LEFT><<<grid, THREADS, 0, s>>>(lhs, rhs, twiddle, out, M, K, N, p, transpose_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: out[b] = (A @ X[b]) mod p, times twiddle mod p when twiddle != NULL.
int plane_matmul_data_right(const int8_t* a_planes, const long long* x, const long long* twiddle,
                            long long* out, int batch, int M, int K, int N, int n_planes, long long p,
                            void* stream) {
  return launch<false>(a_planes, x, twiddle, out, batch, M, K, N, n_planes, p, 0, stream);
}

// K2: out[b] = (X[b] @ B) mod p, stored as (N, M) when transpose_out != 0.
int plane_matmul_data_left(const long long* x, const int8_t* b_planes, long long* out, int batch,
                           int M, int K, int N, int n_planes, long long p, int transpose_out,
                           void* stream) {
  return launch<true>(x, b_planes, nullptr, out, batch, M, K, N, n_planes, p, transpose_out, stream);
}

}  // extern "C"
