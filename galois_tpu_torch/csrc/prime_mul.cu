// Kernels K9 and K10: prime-field products.
//
// Replaces galois_tpu/ops/_pallas/_elementwise.py:
//   K9  prime_multiply_pallas      (:89, pl.pallas_call through _tiled_call :59)
//       (a * b) mod 2^31 - 1, the multiply of GF(2^31 - 1)
//   K10 goldilocks_multiply_pallas (:186, pl.pallas_call :224)
//       (a * b) mod p, p = 2^64 - 2^32 + 1, on planar (4, N) uint16 limbs
// Wrappers and plain torch versions: ops/_elementwise.py.
//
// What bounds them on the H100: HBM bytes. K9 reads two int64 operands and
// writes one (24 B per element, the port's int storage); K10 reads two
// 4-limb uint16 operands and writes one (also 24 B). At 2^24 elements that
// is 403 MB, 0.120 ms at 3.35 TB/s. The arithmetic is a few dozen integer
// instructions per element (one 64-bit product, and for K10 a 64 x 64 ->
// 128 product and its fold), well under the memory time.
//
// Design: compute the map directly in 64-bit registers. The TPU kernels
// build the products from 16-bit halves in u32 lanes with signed 16-bit
// column folds, because Mosaic has no 64-bit integers; none of that is
// carried over, nor the (8, 1024) / (16, 1024) tiles and their padding.
//   K9:  x = a * b < 2^62, then two folds x -> (x & p) + (x >> 31)
//        (2^31 = 1 mod p) leave x <= p; p maps to 0.
//   K10: x = a0 | a1 << 16 | a2 << 32 | a3 << 48 for each operand, then
//        lo = x * y, hi = __umul64hi(x, y); with 2^64 = 2^32 - 1 and
//        2^96 = -1 (mod p), lo + 2^64 hi = lo + (2^32 - 1) hi_lo - hi_hi.
//        Two wrapping 64-bit steps and one conditional subtract give the
//        canonical residue of ANY 128-bit product, so operands in [p, 2^64)
//        (non-canonical limbs) are reduced correctly too.
// One grid-stride pass. Where the operands are aligned, each thread loads
// 16 bytes per operand and plane (K9: 2 int64 elements, K10: 8 uint16
// limbs); the ragged or unaligned case takes the scalar loop.
//
// Broadcast: b may repeat with a period nb that divides n (b holds nb
// elements; element i of a pairs with element i % nb of b). Horner's inner
// step multiplies (k, N) by (1, N) this way without materializing x k
// times. The grid's y dimension walks the repetitions, so no thread
// divides by nb.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint64_t M31 = 0x7FFFFFFFull;
constexpr uint64_t GOLD_P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p = 2^32 - 1

__device__ __forceinline__ int64_t m31_mul(int64_t a, int64_t b) {
  uint64_t x = static_cast<uint64_t>(a) * static_cast<uint64_t>(b);  // < 2^62
  x = (x & M31) + (x >> 31);  // <= 2^32 - 2
  x = (x & M31) + (x >> 31);  // <= p
  return static_cast<int64_t>(x >= M31 ? x - M31 : x);
}

__device__ __forceinline__ uint64_t gold_mul(uint64_t x, uint64_t y) {
  const uint64_t lo = x * y;
  const uint64_t hi = __umul64hi(x, y);
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;  // the borrow took 2^64 = EPS (mod p); t0 >= 2^64 - 2^32 here
  const uint64_t t1 = hi_lo * EPS;  // < 2^64
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += EPS;  // the carry gave 2^64 = EPS (mod p); no second carry
  return t2 >= GOLD_P ? t2 - GOLD_P : t2;
}

// ---- K9 ----------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
m31_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ out,
           long long n, long long nb) {
  const long long reps = n / nb;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long start = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long r = blockIdx.y; r < reps; r += gridDim.y) {
    const int64_t* ar = a + r * nb;
    int64_t* outr = out + r * nb;
    if constexpr (VEC) {
      for (long long j = 2 * start; j < nb; j += 2 * stride) {
        const longlong2 va = *reinterpret_cast<const longlong2*>(ar + j);
        const longlong2 vb = *reinterpret_cast<const longlong2*>(b + j);
        longlong2 vo;
        vo.x = m31_mul(va.x, vb.x);
        vo.y = m31_mul(va.y, vb.y);
        *reinterpret_cast<longlong2*>(outr + j) = vo;
      }
    } else {
      for (long long j = start; j < nb; j += stride) outr[j] = m31_mul(ar[j], b[j]);
    }
  }
}

// ---- K10 ---------------------------------------------------------------

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// limb k of element e (0..7) of a 16-byte plane vector
__device__ __forceinline__ uint64_t limb(const uint4& v, int e) {
  return (word(v, e >> 1) >> ((e & 1) * 16)) & 0xFFFFu;
}

__device__ __forceinline__ uint32_t pack(uint64_t lo_elem, uint64_t hi_elem, int k) {
  return static_cast<uint32_t>((lo_elem >> (16 * k)) & 0xFFFFu) |
         (static_cast<uint32_t>((hi_elem >> (16 * k)) & 0xFFFFu) << 16);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gold_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b, uint16_t* __restrict__ out,
            long long n, long long nb) {
  const long long reps = n / nb;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long start = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long r = blockIdx.y; r < reps; r += gridDim.y) {
    const long long base = r * nb;
    if constexpr (VEC) {
      for (long long j = 8 * start; j < nb; j += 8 * stride) {
        uint4 va[4], vb[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          va[k] = *reinterpret_cast<const uint4*>(a + k * n + base + j);
          vb[k] = *reinterpret_cast<const uint4*>(b + k * nb + j);
        }
        uint64_t res[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint64_t x = limb(va[0], e) | (limb(va[1], e) << 16) | (limb(va[2], e) << 32) | (limb(va[3], e) << 48);
          const uint64_t y = limb(vb[0], e) | (limb(vb[1], e) << 16) | (limb(vb[2], e) << 32) | (limb(vb[3], e) << 48);
          res[e] = gold_mul(x, y);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint4 vo;
          vo.x = pack(res[0], res[1], k);
          vo.y = pack(res[2], res[3], k);
          vo.z = pack(res[4], res[5], k);
          vo.w = pack(res[6], res[7], k);
          *reinterpret_cast<uint4*>(out + k * n + base + j) = vo;
        }
      }
    } else {
      for (long long j = start; j < nb; j += stride) {
        const long long i = base + j;
        const uint64_t x = static_cast<uint64_t>(a[i]) | (static_cast<uint64_t>(a[n + i]) << 16) |
                           (static_cast<uint64_t>(a[2 * n + i]) << 32) | (static_cast<uint64_t>(a[3 * n + i]) << 48);
        const uint64_t y = static_cast<uint64_t>(b[j]) | (static_cast<uint64_t>(b[nb + j]) << 16) |
                           (static_cast<uint64_t>(b[2 * nb + j]) << 32) | (static_cast<uint64_t>(b[3 * nb + j]) << 48);
        const uint64_t res = gold_mul(x, y);
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k * n + i] = static_cast<uint16_t>(res >> (16 * k));
      }
    }
  }
}

// Grid: x covers one period (per elements per thread and loop), y the
// repetitions, about 8 resident blocks per SM in all.
cudaError_t grid_for(long long nb, long long reps, int per_thread, dim3* grid) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const long long gy = reps < 65535 ? reps : 65535;
  const long long want_x = (nb + static_cast<long long>(THREADS) * per_thread - 1) / (static_cast<long long>(THREADS) * per_thread);
  long long budget = (8LL * sms + gy - 1) / gy;
  if (budget < 1) budget = 1;
  grid->x = static_cast<unsigned>(want_x < budget ? want_x : budget);
  grid->y = static_cast<unsigned>(gy);
  grid->z = 1;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// K9: out[i] = a[i] * b[i % nb] mod 2^31 - 1; int64 storage in [0, 2^31 - 1).
int m31_multiply_launch(const int64_t* a, const int64_t* b, int64_t* out, long long n, long long nb,
                        void* stream) {
  if (n <= 0 || nb <= 0 || n % nb != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = nb % 2 == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  dim3 grid;
  cudaError_t err = grid_for(nb, n / nb, vec ? 2 : 1, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) {
    m31_kernel<true><<<grid, THREADS, 0, s>>>(a, b, out, n, nb);
  } else {
    m31_kernel<false><<<grid, THREADS, 0, s>>>(a, b, out, n, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10: planar (4, n) uint16 a and out, (4, nb) b; out = a * b mod p with b
// repeating every nb elements.
int goldilocks_multiply_launch(const uint16_t* a, const uint16_t* b, uint16_t* out, long long n,
                               long long nb, void* stream) {
  if (n <= 0 || nb <= 0 || n % nb != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = nb % 8 == 0 && n % 8 == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  dim3 grid;
  cudaError_t err = grid_for(nb, n / nb, vec ? 8 : 1, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) {
    gold_kernel<true><<<grid, THREADS, 0, s>>>(a, b, out, n, nb);
  } else {
    gold_kernel<false><<<grid, THREADS, 0, s>>>(a, b, out, n, nb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
