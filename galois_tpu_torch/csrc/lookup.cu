// Kernels K3-K6: the EXP/LOG table gathers of lookup mode.
//
// Replaces galois_tpu/ops/_pallas/_elementwise.py (all four reach
// pl.pallas_call through _lookup_call, :305):
//   K3 lookup_multiply_pallas   (:324)  out = EXP[LOG[a] + LOG[b]], 0 where a or b is 0
//   K4 lookup_divide_pallas     (:341)  out = EXP[LOG[a] + (q-1) - LOG[b]], 0 where a is 0
//   K5 lookup_reciprocal_pallas (:358)  out = EXP[(q-1) - LOG[a]]
//   K6 lookup_log_pallas        (:372)  out = LOG[a], written as int64
// EXP is int32 of length 2(q-1), doubled so that every index above stays
// below 2(q-1) without a modulo; LOG is int32 of length q, LOG[0] = 0. The
// callers check b != 0 (K4) and a != 0 (K5); the kernels index the tables
// the same way for every input in [0, q), as the plain versions in
// ops/_lookup.py do. Elements are storage values in [0, q): uint8 for
// q <= 2^8, int64 otherwise, loaded and stored as they are.
//
// What bounds it on the H100: HBM bytes. Each element moves its operands
// in and its result out (3 B for a uint8 multiply or divide, 24 B for an
// int64 one, 9 B for K6 on uint8 input), against at most three table reads
// that hit shared memory or L2. At 2^24 elements: 50 MB, about 15 us at
// 3.35 TB/s, for a uint8 multiply; 403 MB, about 120 us, for int64.
//
// Design: one grid-stride pass, at most as many blocks as the SMs hold at
// once, so the table staging below is paid once per resident block. The
// caller picks where the tables live (ops/_lookup.py, SMEM_MAX_ORDER):
// - shared (orders <= 2^14): each block copies LOG and EXP into shared
//   memory as uint16 (6q bytes, at most 96 KB; the launcher raises the
//   block's dynamic shared memory limit above 48 KB) and gathers from it;
// - global (larger orders, up to 2^20, 12 MB of int32 tables): the gathers
//   read the global tables through the read-only path (__ldg); the H100's
//   50 MB L2 holds the largest table.
// What differs from the TPU kernels: Mosaic's gather needs (rows, 128)
// source and index registers, so the TPU serves tables in 128-entry chunks
// through a select tree (_gather_chunks, _taa_lanes) and pads everything
// to 128 (_pad128) and to (256, 128) blocks. A CUDA thread indexes shared
// memory directly, so none of that is carried over; the ragged tail is the
// loop bound.
//
// The one entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

enum { OP_MUL = 0, OP_DIV = 1, OP_RECIP = 2, OP_LOG = 3 };

template <bool SMEM>
__device__ __forceinline__ int tab(const uint16_t* s, const int32_t* __restrict__ g, int i) {
  if constexpr (SMEM) {
    return s[i];
  } else {
    return __ldg(g + i);
  }
}

// Shared memory (SMEM): LOG[0, q) then, except for K6, EXP[0, 2(q-1)).
template <int OP, typename T, typename Out, bool SMEM>
__global__ void __launch_bounds__(THREADS)
lookup_kernel(const T* __restrict__ a, const T* __restrict__ b, Out* __restrict__ out,
              const int32_t* __restrict__ exp_g, const int32_t* __restrict__ log_g, int q,
              long long n) {
  extern __shared__ uint16_t s_tab[];
  if constexpr (SMEM) {
    for (int i = threadIdx.x; i < q; i += THREADS) s_tab[i] = static_cast<uint16_t>(log_g[i]);
    if constexpr (OP != OP_LOG) {
      for (int i = threadIdx.x; i < 2 * (q - 1); i += THREADS)
        s_tab[q + i] = static_cast<uint16_t>(exp_g[i]);
    }
    __syncthreads();
  }
  const uint16_t* s_log = s_tab;
  const uint16_t* s_exp = s_tab + q;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; i < n; i += stride) {
    const int x = static_cast<int>(a[i]);
    if constexpr (OP == OP_MUL) {
      const int y = static_cast<int>(b[i]);
      const int r = tab<SMEM>(s_exp, exp_g, tab<SMEM>(s_log, log_g, x) + tab<SMEM>(s_log, log_g, y));
      out[i] = static_cast<Out>((x == 0 || y == 0) ? 0 : r);
    } else if constexpr (OP == OP_DIV) {
      const int y = static_cast<int>(b[i]);
      const int r = tab<SMEM>(s_exp, exp_g, tab<SMEM>(s_log, log_g, x) + (q - 1) - tab<SMEM>(s_log, log_g, y));
      out[i] = static_cast<Out>(x == 0 ? 0 : r);
    } else if constexpr (OP == OP_RECIP) {
      out[i] = static_cast<Out>(tab<SMEM>(s_exp, exp_g, (q - 1) - tab<SMEM>(s_log, log_g, x)));
    } else {
      out[i] = static_cast<Out>(tab<SMEM>(s_log, log_g, x));
    }
  }
}

template <int OP, typename T, typename Out, bool SMEM>
cudaError_t launch(const void* a, const void* b, void* out, const int32_t* exp_t,
                   const int32_t* log_t, int q, long long n, cudaStream_t stream) {
  auto kernel = lookup_kernel<OP, T, Out, SMEM>;
  const int smem = SMEM ? static_cast<int>(sizeof(uint16_t)) * (OP == OP_LOG ? q : q + 2 * (q - 1)) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  long long blocks = (n + THREADS - 1) / THREADS;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  lookup_kernel<OP, T, Out, SMEM><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<Out*>(out), exp_t, log_t, q, n);
  return cudaGetLastError();
}

template <int OP, typename T, typename Out>
cudaError_t launch_placed(bool smem, const void* a, const void* b, void* out, const int32_t* exp_t,
                          const int32_t* log_t, int q, long long n, cudaStream_t stream) {
  if (smem) return launch<OP, T, Out, true>(a, b, out, exp_t, log_t, q, n, stream);
  return launch<OP, T, Out, false>(a, b, out, exp_t, log_t, q, n, stream);
}

template <typename T>
cudaError_t launch_op(int op, bool smem, const void* a, const void* b, void* out, const int32_t* exp_t,
                      const int32_t* log_t, int q, long long n, cudaStream_t stream) {
  switch (op) {
    case OP_MUL: return launch_placed<OP_MUL, T, T>(smem, a, b, out, exp_t, log_t, q, n, stream);
    case OP_DIV: return launch_placed<OP_DIV, T, T>(smem, a, b, out, exp_t, log_t, q, n, stream);
    case OP_RECIP: return launch_placed<OP_RECIP, T, T>(smem, a, b, out, exp_t, log_t, q, n, stream);
    case OP_LOG: return launch_placed<OP_LOG, T, int64_t>(smem, a, b, out, exp_t, log_t, q, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// op: 0 multiply (K3), 1 divide (K4), 2 reciprocal (K5), 3 log (K6).
// elem_bytes: 1 for uint8 storage, 8 for int64. smem: nonzero to stage the
// tables in shared memory (q <= 2^16). b is unused by ops 2 and 3, exp_t by 3.
int lookup_launch(int op, int elem_bytes, int smem, const void* a, const void* b, void* out,
                  const int32_t* exp_t, const int32_t* log_t, int q, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (smem && q > (1 << 16)) {
    err = cudaErrorInvalidValue;  // uint16 shared entries hold values below 2^16
  } else if (elem_bytes == 1) {
    err = launch_op<uint8_t>(op, smem != 0, a, b, out, exp_t, log_t, q, n, s);
  } else if (elem_bytes == 8) {
    err = launch_op<int64_t>(op, smem != 0, a, b, out, exp_t, log_t, q, n, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
