// Kernels K12 and K13: the two scans of lfsr.py, each one launch of one CTA,
// over the int-storage fields of field_scan.cuh. Wrappers and plain torch
// versions: ops/_lfsr_scan.py. Storage: uint8 for orders <= 2^8, int64 above
// (the port's int storage), widened to 32-bit registers.
//
// K12, lfsr_step: n ticks of one shift register of order k (its taps),
// replacing the four lax.scan tick functions of galois_tpu/lfsr.py:63-106
// (Fibonacci and Galois, forward and backward). For k <= 1024 thread i holds
// state element i and tap i in registers, one warp for k <= 32, up to 32
// warps; above (a long Berlekamp-Massey result has order N / 2), the
// state's two buffers and the taps live in shared memory while 12 k bytes
// fit (k <= 19,008), else in global scratch from the wrapper, and each of
// 1024 threads takes every 1024th element. Per tick:
//   Fibonacci forward  the dot of state and taps (a block reduction: warp
//                      shuffles, then one shared slot a warp), output state
//                      k - 1, then the shift: state i takes state i - 1,
//                      state 0 the dot;
//   Galois forward     output f = state k - 1 (broadcast), state i takes
//                      state i - 1 + f tap i (state 0: f tap 0);
//   Fibonacci backward s = (state 0 - sum_{i>=1} state i tap i-1) / tap k-1,
//                      state i takes state i + 1, state k - 1 takes s;
//   Galois backward    f = state 0 / tap 0, state i takes state i + 1 - f
//                      tap i + 1, state k - 1 takes f.
// The reciprocal of the end tap comes from the host once, as an argument.
// Each tick's output goes into a shared-memory stage of OUT_CHUNK elements,
// which the block writes out in one coalesced pass when it is full and at
// the end. A tick is a chain of dependent steps (a reduction or a
// broadcast, then the shift), so the scan is bound by that latency; bytes
// are no bound.
//
// K13, berlekamp_massey_long: the Berlekamp-Massey scan of one sequence of N
// elements, replacing the lax.scan of galois_tpu/lfsr.py:281-326 step for
// step, so that c and L equal the JAX package's on every sequence (the
// minimal LFSR of a high-complexity sequence is not unique). Capacity
// K = N + 1. Three buffers of K 32-bit elements (c, b and a spare) live in
// shared memory while 12 K bytes fit (N < 18,900), else in global scratch
// from the wrapper. Step t: d = sum_i c[i] seq[t - i] over i up to the
// highest index c can hold a nonzero at (tracked on the host side of the
// loop, uniform over the block), by a block reduction; if d != 0,
// coef = d / bcoef and c - coef x^m b, written into the spare buffer when
// L grows (the old c becomes b by a swap of buffer indices, no copy), in
// place otherwise; the reciprocal of a new bcoef once per length change.
// Each step is a reduction and a barrier or two: the scan is bound by that
// latency and by the dot's reads, N^2 / 4 products for a sequence of
// complexity N / 2, spread over 1024 threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_scan.cuh"

namespace {

using field_scan::Field;

constexpr int BM_THREADS = 1024;
constexpr int OUT_CHUNK = 1024;  // K12's staged outputs
constexpr size_t SMEM_LIMIT = 227 * 1024;
// K12 above 1024 taps: two state buffers and the taps, beside the stage
constexpr size_t wide_bytes(long long k) { return 3 * static_cast<size_t>(k) * sizeof(uint32_t); }
constexpr bool wide_in_smem(long long k) { return wide_bytes(k) + (OUT_CHUNK + 64) * sizeof(uint32_t) <= SMEM_LIMIT; }

struct Block {
  uint32_t* part;  // one slot a warp
  uint32_t* edge;  // one slot a warp: a warp's last (or first) lane
  int lane, warp, nw;
};

__device__ __forceinline__ uint32_t warp_sum(const Field& F, uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = field_scan::add(F, v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The field sum of v over the block, in every thread.
__device__ __forceinline__ uint32_t block_sum(const Field& F, const Block& B, uint32_t v) {
  v = warp_sum(F, v);
  if (B.nw == 1) return v;
  if (B.lane == 0) B.part[B.warp] = v;
  __syncthreads();
  uint32_t s = B.part[0];
  for (int w = 1; w < B.nw; ++w) s = field_scan::add(F, s, B.part[w]);
  __syncthreads();
  return s;
}

// v of thread src, in every thread.
__device__ __forceinline__ uint32_t from(const Block& B, uint32_t v, int src) {
  if (B.nw == 1) return __shfl_sync(0xffffffffu, v, src);
  if (static_cast<int>(threadIdx.x) == src) B.part[0] = v;
  __syncthreads();
  const uint32_t r = B.part[0];
  __syncthreads();
  return r;
}

// Thread i gets v of thread i - 1; thread 0 gets fill.
__device__ __forceinline__ uint32_t shift_up(const Block& B, uint32_t v, uint32_t fill) {
  uint32_t u = __shfl_up_sync(0xffffffffu, v, 1);
  if (B.nw > 1) {
    if (B.lane == 31) B.edge[B.warp] = v;
    __syncthreads();
    if (B.lane == 0 && B.warp) u = B.edge[B.warp - 1];
    __syncthreads();
  }
  return threadIdx.x == 0 ? fill : u;
}

// Thread i gets v of thread i + 1; thread k - 1 gets fill.
__device__ __forceinline__ uint32_t shift_down(const Block& B, uint32_t v, uint32_t fill, int k) {
  uint32_t u = __shfl_down_sync(0xffffffffu, v, 1);
  if (B.nw > 1) {
    if (B.lane == 0) B.edge[B.warp] = v;
    __syncthreads();
    if (B.lane == 31 && B.warp + 1 < B.nw) u = B.edge[B.warp + 1];
    __syncthreads();
  }
  return static_cast<int>(threadIdx.x) == k - 1 ? fill : u;
}

// Tick t's output v (already in every thread that may be `writer`) into the
// stage; the whole block writes the stage out when it is full or at the
// last tick. The test is uniform across the block.
template <typename T>
__device__ __forceinline__ void emit(uint32_t* stage, T* out, long long t, long long steps, bool writer, uint32_t v) {
  const int slot = static_cast<int>(t % OUT_CHUNK);
  if (writer) stage[slot] = v;
  if (slot == OUT_CHUNK - 1 || t == steps - 1) {
    __syncthreads();
    T* dst = out + (t - slot);
    for (int j = threadIdx.x; j <= slot; j += blockDim.x) dst[j] = static_cast<T>(stage[j]);
    __syncthreads();
  }
}

enum Mode : int { FIB_FWD = 0, FIB_BWD = 1, GAL_FWD = 2, GAL_BWD = 3 };

template <typename T>
__global__ void __launch_bounds__(1024) lfsr_kernel(const T* __restrict__ state, const T* __restrict__ taps,
                                                    T* __restrict__ state_out, T* __restrict__ out, long long steps,
                                                    int k, int mode, uint32_t inv_tap, Field F) {
  __shared__ uint32_t part[32], edge[32], stage[OUT_CHUNK];
  const int i = threadIdx.x;
  const Block B{part, edge, i & 31, i >> 5, static_cast<int>(blockDim.x) >> 5};
  const bool live = i < k;
  uint32_t s = live ? static_cast<uint32_t>(state[i]) : 0u;
  const uint32_t tp = live ? static_cast<uint32_t>(taps[i]) : 0u;
  const uint32_t tp_prev = shift_up(B, tp, 0u);  // tap i - 1, for the Fibonacci backward dot
  for (long long t = 0; t < steps; ++t) {
    if (mode == FIB_FWD) {
      const uint32_t d = block_sum(F, B, field_scan::mul(F, s, tp));
      emit(stage, out, t, steps, i == k - 1, s);
      s = shift_up(B, s, d);
    } else if (mode == GAL_FWD) {
      const uint32_t f = from(B, s, k - 1);
      emit(stage, out, t, steps, i == 0, f);
      s = field_scan::add(F, shift_up(B, s, 0u), field_scan::mul(F, f, tp));
    } else if (mode == FIB_BWD) {
      const uint32_t dot = block_sum(F, B, field_scan::mul(F, s, tp_prev));
      const uint32_t sv = field_scan::mul(F, field_scan::sub(F, from(B, s, 0), dot), inv_tap);
      emit(stage, out, t, steps, i == 0, sv);
      s = shift_down(B, s, sv, k);
    } else {
      const uint32_t f = field_scan::mul(F, from(B, s, 0), inv_tap);
      emit(stage, out, t, steps, i == 0, f);
      s = shift_down(B, field_scan::sub(F, s, field_scan::mul(F, f, tp)), f, k);
    }
  }
  if (live) state_out[i] = static_cast<T>(s);
}

// K12 for k > 1024: the state (two buffers, one a tick) and the taps in
// shared memory (SMEM) or in the wrapper's global scratch of 3 k uint32,
// 1024 threads each taking elements j = tid, tid + 1024, ...; the barrier
// that ends a tick makes its writes, shared or global, visible to the next.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(1024) lfsr_wide_kernel(const T* __restrict__ state, const T* __restrict__ taps,
                                                         T* __restrict__ state_out, T* __restrict__ out,
                                                         long long steps, int k, int mode, uint32_t inv_tap,
                                                         uint32_t* __restrict__ scratch, Field F) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t part[32], edge[32], stage[OUT_CHUNK];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Block B{part, edge, tid & 31, tid >> 5, nt >> 5};
  uint32_t* base = SMEM ? smem : scratch;
  uint32_t* buf[2] = {base, base + k};
  uint32_t* tp = base + 2 * k;
  for (int j = tid; j < k; j += nt) {
    buf[0][j] = static_cast<uint32_t>(state[j]);
    tp[j] = static_cast<uint32_t>(taps[j]);
  }
  __syncthreads();
  for (long long t = 0; t < steps; ++t) {
    const uint32_t* cur = buf[t & 1];
    uint32_t* nxt = buf[(t + 1) & 1];
    if (mode == FIB_FWD) {
      uint32_t acc = 0;
      for (int j = tid; j < k; j += nt) acc = field_scan::add(F, acc, field_scan::mul(F, cur[j], tp[j]));
      const uint32_t d = block_sum(F, B, acc);
      emit(stage, out, t, steps, tid == 0, cur[k - 1]);
      for (int j = tid; j < k; j += nt) nxt[j] = j ? cur[j - 1] : d;
    } else if (mode == GAL_FWD) {
      const uint32_t f = cur[k - 1];
      emit(stage, out, t, steps, tid == 0, f);
      for (int j = tid; j < k; j += nt) nxt[j] = field_scan::add(F, j ? cur[j - 1] : 0u, field_scan::mul(F, f, tp[j]));
    } else if (mode == FIB_BWD) {
      uint32_t acc = 0;
      for (int j = tid + 1; j < k; j += nt) acc = field_scan::add(F, acc, field_scan::mul(F, cur[j], tp[j - 1]));
      const uint32_t sv = field_scan::mul(F, field_scan::sub(F, cur[0], block_sum(F, B, acc)), inv_tap);
      emit(stage, out, t, steps, tid == 0, sv);
      for (int j = tid; j < k; j += nt) nxt[j] = j + 1 < k ? cur[j + 1] : sv;
    } else {
      const uint32_t f = field_scan::mul(F, cur[0], inv_tap);
      emit(stage, out, t, steps, tid == 0, f);
      for (int j = tid; j < k; j += nt) {
        nxt[j] = j + 1 < k ? field_scan::sub(F, cur[j + 1], field_scan::mul(F, f, tp[j + 1])) : f;
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += nt) state_out[j] = static_cast<T>(buf[steps & 1][j]);
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(BM_THREADS) bm_long_kernel(const T* __restrict__ seq, long long N,
                                                             T* __restrict__ c_out, long long* __restrict__ L_out,
                                                             uint32_t* __restrict__ scratch, Field F) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t part[32], edge[32];
  const int tid = threadIdx.x;
  const Block B{part, edge, tid & 31, tid >> 5, BM_THREADS >> 5};
  const long long K = N + 1;
  uint32_t* base = SMEM ? smem : scratch;
  uint32_t* buf[3] = {base, base + K, base + 2 * K};
  for (long long j = tid; j < 3 * K; j += BM_THREADS) base[j] = (j == 0 || j == K) ? 1u : 0u;
  __syncthreads();
  int ci = 0, bi = 1, ti = 2;  // buffers of c, b and the spare
  long long L = 0, m = 1, ext_c = 0, ext_b = 0;  // ext: the highest index that may hold a nonzero
  uint32_t inv_b = 1;  // 1 / bcoef
  for (long long t = 0; t < N; ++t) {
    const uint32_t* c = buf[ci];
    uint32_t acc = 0;
    const long long top = ext_c < t ? ext_c : t;
    for (long long j = tid; j <= top; j += BM_THREADS) {
      acc = field_scan::add(F, acc, field_scan::mul(F, c[j], static_cast<uint32_t>(seq[t - j])));
    }
    const uint32_t d = block_sum(F, B, acc);
    if (d == 0) {
      ++m;
      continue;
    }
    const uint32_t coef = field_scan::mul(F, d, inv_b);
    long long next = ext_c > m + ext_b ? ext_c : m + ext_b;
    if (next > K - 1) next = K - 1;
    const uint32_t* b = buf[bi];
    if (2 * L <= t) {  // L grows: c_new into the spare, the old c becomes b
      uint32_t* tmp = buf[ti];
      for (long long j = tid; j <= next; j += BM_THREADS) {
        uint32_t v = c[j];
        if (j >= m && j - m <= ext_b) v = field_scan::sub(F, v, field_scan::mul(F, coef, b[j - m]));
        tmp[j] = v;
      }
      __syncthreads();
      const int old_b = bi;
      bi = ci;
      ci = ti;
      ti = old_b;
      ext_b = ext_c;
      inv_b = field_scan::inv(F, d);
      L = t + 1 - L;
      m = 1;
    } else {
      uint32_t* cw = buf[ci];
      for (long long j = m + tid; j <= m + ext_b && j < K; j += BM_THREADS) {
        cw[j] = field_scan::sub(F, cw[j], field_scan::mul(F, coef, b[j - m]));
      }
      __syncthreads();
      ++m;
    }
    ext_c = next;
  }
  for (long long j = tid; j < K; j += BM_THREADS) c_out[j] = static_cast<T>(buf[ci][j]);
  if (tid == 0) *L_out = L;
}

template <typename T>
cudaError_t launch_lfsr(const void* state, const void* taps, void* state_out, void* out, long long steps, int k,
                        int mode, uint32_t inv_tap, uint32_t* scratch, const Field& F, cudaStream_t s) {
  const auto* st = static_cast<const T*>(state);
  const auto* tp = static_cast<const T*>(taps);
  if (k <= 1024) {
    const int threads = (k + 31) / 32 * 32;
    lfsr_kernel<T><<<1, threads, 0, s>>>(st, tp, static_cast<T*>(state_out), static_cast<T*>(out), steps, k, mode,
                                         inv_tap, F);
    return cudaGetLastError();
  }
  if (wide_in_smem(k)) {
    const size_t bytes = wide_bytes(k);
    auto kernel = lfsr_wide_kernel<T, true>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<1, 1024, bytes, s>>>(st, tp, static_cast<T*>(state_out), static_cast<T*>(out), steps, k, mode, inv_tap,
                                  nullptr, F);
  } else {
    if (!scratch) return cudaErrorInvalidValue;
    lfsr_wide_kernel<T, false><<<1, 1024, 0, s>>>(st, tp, static_cast<T*>(state_out), static_cast<T*>(out), steps, k,
                                                  mode, inv_tap, scratch, F);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bm(const void* seq, long long N, void* c_out, long long* L_out, uint32_t* scratch,
                      const Field& F, cudaStream_t s) {
  const size_t bytes = 3 * static_cast<size_t>(N + 1) * sizeof(uint32_t);
  if (bytes + 512 <= SMEM_LIMIT) {
    auto kernel = bm_long_kernel<T, true>;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
    }
    kernel<<<1, BM_THREADS, bytes, s>>>(static_cast<const T*>(seq), N, static_cast<T*>(c_out), L_out, nullptr, F);
  } else {
    if (!scratch) return cudaErrorInvalidValue;
    bm_long_kernel<T, false><<<1, BM_THREADS, 0, s>>>(static_cast<const T*>(seq), N, static_cast<T*>(c_out), L_out,
                                                      scratch, F);
  }
  return cudaGetLastError();
}

bool valid_field(const Field& F) {
  return (F.kind == field_scan::PRIME && F.p >= 2) || (F.kind == field_scan::BINARY && F.m >= 2 && F.m <= 32) ||
         (F.kind == field_scan::TABLES && F.exp && F.log && F.q1 < (1u << 16));
}

}  // namespace

// K12: `steps` ticks of the register (state, taps: k elements each,
// contiguous; uint8 storage when byte_storage, else int64); mode 0-3 as Mode;
// state_out (k) and out (steps) written. scratch: 3 k uint32 of global
// memory, needed when they do not fit in shared memory (lfsr_scratch_needed).
extern "C" int lfsr_step_launch(const void* state, const void* taps, void* state_out, void* out, long long steps,
                                int k, int mode, unsigned inv_tap, unsigned* scratch, int byte_storage, Field F,
                                void* stream) {
  if (steps <= 0 || k < 1 || mode < 0 || mode > 3 || !valid_field(F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      byte_storage ? launch_lfsr<uint8_t>(state, taps, state_out, out, steps, k, mode, inv_tap, scratch, F, s)
                   : launch_lfsr<long long>(state, taps, state_out, out, steps, k, mode, inv_tap, scratch, F, s);
  return static_cast<int>(e);
}

extern "C" int lfsr_scratch_needed(int k) { return k > 1024 && !wide_in_smem(k); }

// K13: c_out (N + 1) and L_out (1) of the Berlekamp-Massey scan of seq (N);
// scratch: 3 (N + 1) uint32 of global memory, needed when they do not fit in
// shared memory (bm_long_scratch_needed).
extern "C" int bm_long_launch(const void* seq, long long N, void* c_out, long long* L_out, unsigned* scratch,
                              int byte_storage, Field F, void* stream) {
  if (N < 1 || !valid_field(F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = byte_storage ? launch_bm<uint8_t>(seq, N, c_out, L_out, scratch, F, s)
                                     : launch_bm<long long>(seq, N, c_out, L_out, scratch, F, s);
  return static_cast<int>(e);
}

extern "C" int bm_long_scratch_needed(long long N) {
  return 3 * static_cast<size_t>(N + 1) * sizeof(uint32_t) + 512 > SMEM_LIMIT;
}
