// Kernels K3-K6: the EXP/LOG table gathers of lookup mode.
//
// Replaces galois_tpu/ops/_pallas/_elementwise.py (all four reach
// pl.pallas_call through _lookup_call, :305):
//   K3 lookup_multiply_pallas   (:324)  out = EXP[LOG[a] + LOG[b]], 0 where a or b is 0
//   K4 lookup_divide_pallas     (:341)  out = EXP[LOG[a] + (q-1) - LOG[b]], 0 where a is 0
//   K5 lookup_reciprocal_pallas (:358)  out = EXP[(q-1) - LOG[a]]
//   K6 lookup_log_pallas        (:372)  out = LOG[a], written as int64
// EXP is int32 of length 2(q-1), doubled so that every index above stays
// below 2(q-1) without a modulo; LOG is int32 of length q, LOG[0] = 0; INV,
// built from them by pack_tables, is INV[r] = EXP[(q-1) - LOG[r]]. The
// callers check b != 0 (K4) and a != 0 (K5); the kernels index the tables
// the same way for every input in [0, q), as the plain versions in
// ops/_lookup.py do. Elements are storage values in [0, q): uint8 for
// q <= 2^8, int64 otherwise.
//
// What bounds it on the H100: HBM bytes, as long as the table reads stay
// cheaper. Each element moves its operands in and its result out: 3 B for a
// uint8 multiply or divide (50 MB at 2^24, 15 us at 3.35 TB/s), 24 B for an
// int64 one (403 MB, 120 us), 2 B and 16 B for a reciprocal, 9 B and 16 B
// for a log. Against that stand three table reads a element of K3 and K4
// (conflict-free in shared memory: 1.6 M wavefronts at 2^24, 6 us over 132
// SMs) and one of K5 and K6; where they land decides the kernel.
//
// The kernels take one of four placements, chosen by the wrapper
// (ops/_lookup.py, lookup_placement) and built there once per device
// (pack_tables):
// - bytes (uint8 storage, q <= 2^8): one table of 2(q-1) rows of four
//   bytes, LOG[r], EXP[r], (q-1) - LOG[r] and INV[r], replicated in shared memory
//   once per bank: row r of lane l is the word r * 32 + l, so the 32 lanes
//   of a warp always read 32 different banks (conflict-free at any data; 64
//   KB at q = 2^8). A table read is one byte load at col + 128 r + field,
//   col = this lane's column, with no extraction and no bounds arithmetic:
//   K4 reads (q-1) - LOG[b] from the same row and adds. The zero tests run
//   on whole words (nonzero_bytes).
// - shared (int64, q <= 2^14): LOG (q entries) and EXP reduced to its
//   q - 1 distinct entries, both uint16, in shared memory (at most 64 KB);
//   a sum of logs is brought below q - 1 by one conditional add instead of
//   a doubled table.
// - log-shared (int64, 2^14 < q <= 2^16): LOG alone fills 128 KB of shared
//   memory (one block of 1024 threads a SM); the reduced uint16 EXP (128
//   KB at 2^16) is gathered from global memory through the read-only path,
//   out of the SM's L1 beside the shared memory and the L2: one gather
//   outside shared memory a element, against three of 4 bytes before.
// - global (int64, 2^16 < q <= 2^20): LOG no longer fits 16 bits; the int32
//   tables (12 MB at 2^20) are gathered through the read-only path out of
//   the 50 MB L2.
// Every placement streams 16 bytes of a and of b a thread and step, two
// steps' loads in flight, and reads and writes the streams with evict-first
// hints (__ldcs/__stcs), so that a stream read once does not push the tables
// out of L1 and L2 (Stream, stream_pass; in lookup.cuh with the staging, the
// byte-row reads and K5/K6, which K8 and K8-A share). An operand that is not 16-byte
// aligned (a view one element in) takes two aligned loads and a funnel shift
// a word, so that its chunks line up with the output's; an operand of one
// element (stride 0) is read once a thread, never materialized.
//
// Measured at 2^24 on an H100 80GB HBM3 at its 700 W limit (chip_smoke.py,
// scripts/lookup_timing.py): K3 0.0204 ms on GF(2^8) (bound 0.0150 ms; the
// first design 0.0330) and 0.157 ms on GF(2^16) (bound 0.120 ms; 0.399 with
// three int32 gathers from L2). Two alternatives were measured and left: a
// 64 KB product table (one gather at random banks) ran level with the byte
// rows, 0.0174 against 0.0172 ms, and needs a table per operation; for
// GF(2^16), a 2-block cluster holding LOG in one block's shared memory and
// EXP in the other's, read through distributed shared memory, took 0.322
// against 0.160 ms.
//
// K5 and K6 read the same placements, one table read a element: the bytes
// placement stages its first q rows (the only ones an element indexes, 32
// KB at q = 2^8), K5 reading byte 3 (INV) and K6 byte 0 (LOG); shared and
// log-shared stage only the uint16 segment the kernel reads, INV for K5 or
// LOG for K6 (at most 128 KB at 2^16, one block of 1024 threads a SM), so
// no subtract, doubled EXP or wrap is left; global gathers the int32 LOG,
// and for K5 EXP at (q-1) - LOG, through __ldg. The element stream is the
// same as K3's: 16 bytes of a a thread and step (16 uint8 or two int64
// elements), funnel-shifted where a view is off alignment, and the results
// go out in 16-byte evict-first stores (eight a step where K6 widens 16
// uint8 elements to int64, transposed across the warp by shuffles so that
// each store instruction is contiguous). Measured at 2^24 on an H100 80GB
// HBM3 at 700 W (scripts/lookup_timing.py): K5 and K6 0.098 ms each on
// GF(2^16) (bound 0.080 ms; the first design 0.267 and 0.121 ms, one
// torch.take of a q-entry table 0.144 ms), K6 0.058 ms on GF(2^8) (bound
// 0.045 ms; 0.060 ms), and K5 on GF(2^8) at 2^26 0.051 ms (bound 0.040 ms;
// 0.078 ms).
//
// Every kernel is one grid-stride pass over at most as many blocks as the
// SMs hold at once, so the table staging is paid once per resident block.
// What differs from the TPU kernels: Mosaic's gather needs (rows, 128)
// source and index registers, so the TPU serves tables in 128-entry chunks
// through a select tree (_gather_chunks, _taa_lanes) and pads everything
// to 128 (_pad128) and to (256, 128) blocks. A CUDA thread indexes shared
// memory directly, so none of that is carried over; the ragged tail is the
// loop bound.
//
// The entry points return cudaGetLastError() after their launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookup.cuh"

namespace {

// ----------------------------------------------------------------------
// K3/K4, bytes placement
// ----------------------------------------------------------------------

// rows_g: 2(q-1) words, byte 0 LOG[r] (r < q), byte 1 EXP[r], byte 2
// (q-1) - LOG[r] (r < q). a_one / b_one: that operand is one element.
template <int OP>
__global__ void __launch_bounds__(BYTE_THREADS)
bytes_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, uint8_t* __restrict__ out,
             const uint32_t* __restrict__ rows_g, int rows, int a_one, int b_one, long long n) {
  extern __shared__ uint4 s_rows[];  // rows x 32 lanes x 4 bytes
  stage_byte_rows(s_rows, rows_g, rows, BYTE_THREADS);
  const uint8_t* col = reinterpret_cast<const uint8_t*>(s_rows) + 4 * (threadIdx.x & 31);
  const long long tid = static_cast<long long>(blockIdx.x) * BYTE_THREADS + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * BYTE_THREADS;
  const uint32_t a0 = a_one ? __ldg(a) : 0, b0 = b_one ? __ldg(b) : 0;
  const uint32_t ar = a0 * 0x01010101u, br = b0 * 0x01010101u;
  const Stream A(a, a_one, make_uint4(ar, ar, ar, ar)), B(b, b_one, make_uint4(br, br, br, br));
  const long long nv = n >> 4;
  stream_pass(A, B, reinterpret_cast<uint4*>(out), nv, tid, nthreads, [col](uint4 x, uint4 y) {
    return make_uint4(word_op<OP>(col, x.x, y.x), word_op<OP>(col, x.y, y.y), word_op<OP>(col, x.z, y.z),
                      word_op<OP>(col, x.w, y.w));
  });
  for (long long i = (nv << 4) + tid; i < n; i += nthreads) {  // the ragged tail
    const uint32_t x = a_one ? a0 : a[i], y = b_one ? b0 : b[i];
    const uint32_t r = byte_op<OP>(col, x, y);
    out[i] = static_cast<uint8_t>((x == 0 || (OP == OP_MUL && y == 0)) ? 0 : r);
  }
}

// ----------------------------------------------------------------------
// K3/K4, int64 placements
// ----------------------------------------------------------------------

// The gathers of one placement. log16/exp16: uint16 LOG (q entries) and
// reduced EXP (q - 1 entries); log32/exp32: the int32 tables (global).
template <int PLACE>
struct WideTables {
  const uint16_t* log16;
  const uint16_t* exp16;
  const int32_t* __restrict__ log32;
  const int32_t* __restrict__ exp32;
  int q1;  // q - 1

  __device__ __forceinline__ int lg(int x) const {
    if constexpr (PLACE == PLACE_GLOBAL) return __ldg(log32 + x);
    else return log16[x];
  }

  // One element: x and y are the low words of int64 storage values in [0, q).
  template <int OP>
  __device__ __forceinline__ uint32_t apply(int x, int y) const {
    int r;
    if constexpr (PLACE == PLACE_GLOBAL) {  // the doubled int32 EXP
      r = __ldg(exp32 + (OP == OP_MUL ? lg(x) + lg(y) : lg(x) + q1 - lg(y)));
    } else {  // the reduced EXP: one conditional add of q - 1
      int s = OP == OP_MUL ? lg(x) + lg(y) - q1 : lg(x) - lg(y);
      s += s < 0 ? q1 : 0;
      if constexpr (PLACE == PLACE_SHARED) r = exp16[s];
      else r = __ldg(exp16 + s);
    }
    return (x == 0 || (OP == OP_MUL && y == 0)) ? 0 : r;
  }
};

// packed: uint16 LOG in [0, q8), reduced EXP in [q8, q8 + e8) (q8, e8:
// q and q - 1 rounded up to 8); `staged` uint16 entries of it go to shared
// memory (q8 + e8 for shared, q8 for log-shared, 0 for global). A 16-byte
// chunk holds two elements; their high words are 0.
template <int OP, int PLACE>
__global__ void __launch_bounds__(PLACE == PLACE_LOG_SHARED ? 1024 : 512, PLACE == PLACE_LOG_SHARED ? 1 : 2)
wide_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t* __restrict__ out,
            const uint16_t* __restrict__ packed, int q8, int staged, const int32_t* __restrict__ exp32,
            const int32_t* __restrict__ log32, int q, int a_one, int b_one, long long n) {
  constexpr int THREADS = wide_threads<PLACE>();
  extern __shared__ uint4 s_tab[];
  stage_u16(s_tab, packed, staged, THREADS);
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(s_tab);
  const WideTables<PLACE> t{s16, PLACE == PLACE_SHARED ? s16 + q8 : packed + q8, log32, exp32, q - 1};
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;
  const uint32_t a0 = a_one ? static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(a))) : 0;
  const uint32_t b0 = b_one ? static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(b))) : 0;
  const Stream A(a, a_one, make_uint4(a0, 0, a0, 0)), B(b, b_one, make_uint4(b0, 0, b0, 0));
  const long long nv = n >> 1;
  stream_pass(A, B, reinterpret_cast<uint4*>(out), nv, tid, nthreads, [t](uint4 x, uint4 y) {
    return make_uint4(t.template apply<OP>(x.x, y.x), 0, t.template apply<OP>(x.z, y.z), 0);
  });
  for (long long i = (nv << 1) + tid; i < n; i += nthreads)  // the ragged tail
    out[i] = t.template apply<OP>(a_one ? a0 : static_cast<int>(a[i]), b_one ? b0 : static_cast<int>(b[i]));
}

template <int OP>
cudaError_t launch_binary(int place, const void* a, int a_one, const void* b, int b_one, void* out,
                          const void* packed, const int32_t* exp_t, const int32_t* log_t, int q, long long n,
                          cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t err;
  if (place == PLACE_BYTES) {
    const int rows = 2 * (q - 1), smem = rows * static_cast<int>(ROW);
    auto kernel = bytes_kernel<OP>;
    if ((err = persistent_grid(kernel, BYTE_THREADS, smem, n / 16 + 1, &blocks)) != cudaSuccess) return err;
    kernel<<<blocks, BYTE_THREADS, smem, stream>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<uint8_t*>(out),
        static_cast<const uint32_t*>(packed), rows, a_one, b_one, n);
    return cudaGetLastError();
  }
  const int q8 = round8(q), e8 = round8(q - 1);
  const int64_t *a64 = static_cast<const int64_t*>(a), *b64 = static_cast<const int64_t*>(b);
  int64_t* o64 = static_cast<int64_t*>(out);
  const uint16_t* p16 = static_cast<const uint16_t*>(packed);
#define LAUNCH_WIDE(PLACE, STAGED)                                                                                \
  do {                                                                                                            \
    auto kernel = wide_kernel<OP, PLACE>;                                                                         \
    const int staged = (STAGED), smem = 2 * staged, threads = wide_threads<PLACE>();                              \
    if ((err = persistent_grid(kernel, threads, smem, n / 2 + 1, &blocks)) != cudaSuccess) return err;           \
    kernel<<<blocks, threads, smem, stream>>>(a64, b64, o64, p16, q8, staged, exp_t, log_t, q, a_one, b_one, n); \
    return cudaGetLastError();                                                                                    \
  } while (0)
  switch (place) {
    case PLACE_SHARED: LAUNCH_WIDE(PLACE_SHARED, q8 + e8);
    case PLACE_LOG_SHARED: LAUNCH_WIDE(PLACE_LOG_SHARED, q8);
    case PLACE_GLOBAL: LAUNCH_WIDE(PLACE_GLOBAL, 0);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH_WIDE
}

bool placed_ok(int place, int q, const void* out, const void* packed) {
  const int max_q[] = {1 << 8, 1 << 14, 1 << 16, 1 << 20};
  return place >= 0 && place <= PLACE_GLOBAL && q >= 3 && q <= max_q[place] && aligned16(out) &&
         (place == PLACE_GLOBAL || aligned16(packed));
}

}  // namespace

extern "C" {

// K3 (op 0) and K4 (op 1). place: 0 bytes (uint8 storage, q <= 2^8), 1
// shared (int64, q <= 2^14), 2 log-shared (int64, q <= 2^16), 3 global
// (int64, q <= 2^20). packed: the placement's table from pack_tables
// (ops/_lookup.py), unused by global; exp_t/log_t: the int32 tables, read
// by global only. a_one/b_one: that operand is one element, read by every
// thread (stride 0). out: 16-byte aligned. n: elements of out.
int lookup_binary_launch(int op, int place, const void* a, int a_one, const void* b, int b_one, void* out,
                         const void* packed, const int32_t* exp_t, const int32_t* log_t, int q, long long n,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!placed_ok(place, q, out, packed)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (op) {
    case OP_MUL: err = launch_binary<OP_MUL>(place, a, a_one, b, b_one, out, packed, exp_t, log_t, q, n, s); break;
    case OP_DIV: err = launch_binary<OP_DIV>(place, a, a_one, b, b_one, out, packed, exp_t, log_t, q, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K5 (op 2) and K6 (op 3), placed as K3 and K4: a is uint8 for the bytes
// placement and int64 otherwise, a view at any element offset; out is uint8
// or int64 for K5, int64 for K6, 16-byte aligned; packed and exp_t/log_t as
// for lookup_binary_launch (K6 reads no EXP: exp_t may be null).
int lookup_unary_launch(int op, int place, const void* a, void* out, const void* packed, const int32_t* exp_t,
                        const int32_t* log_t, int q, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!placed_ok(place, q, out, packed)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (op) {
    case OP_RECIP: err = launch_unary<OP_RECIP>(place, a, out, packed, exp_t, log_t, q, n, s); break;
    case OP_LOG: err = launch_unary<OP_LOG>(place, a, out, packed, exp_t, log_t, q, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
