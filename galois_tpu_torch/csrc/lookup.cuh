// The table machinery of kernels K3-K6 (csrc/lookup.cu), shared with K8
// (csrc/gf2m_swar.cu) and K8-A (csrc/gf2m_chain.cu), which read the same
// tables of ops/_lookup.py::pack_tables: the grid of resident blocks, the
// 16-byte evict-first element streams, the per-bank byte rows and their
// staging, and K5/K6 (one table read an element). The head of lookup.cu
// explains the placements and what bounds them on the H100.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum { OP_MUL = 0, OP_DIV = 1, OP_RECIP = 2, OP_LOG = 3 };
enum { PLACE_BYTES = 0, PLACE_SHARED = 1, PLACE_LOG_SHARED = 2, PLACE_GLOBAL = 3 };

// Blocks of at most as many as the SMs hold at once, enough for `units`
// threads' worth of work; raises the dynamic shared memory limit first.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem, long long units, unsigned* blocks) {
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  long long n = (units + threads - 1) / threads;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<unsigned>(n < 1 ? 1 : (n > resident ? resident : n));
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int round8(int x) { return (x + 7) & ~7; }

// ----------------------------------------------------------------------
// The element streams
// ----------------------------------------------------------------------

// One operand's 16-byte chunks. An aligned operand is one load a chunk; one
// k bytes past 16-byte alignment (a view some elements in) is two aligned
// loads and a funnel shift of each word, so its chunks line up with the
// output's; an operand of one element is its value repeated (rep).
struct Stream {
  const uint4* base;  // the operand rounded down to 16 bytes
  int k;              // bytes from there to the operand
  bool one;
  uint4 rep;

  __device__ __forceinline__ Stream(const void* p, bool one_, uint4 rep_) : one(one_), rep(rep_) {
    k = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    base = reinterpret_cast<const uint4*>(static_cast<const char*>(p) - k);
  }

  __device__ __forceinline__ uint4 chunk(long long v) const {
    if (one) return rep;
    const uint4 lo = __ldcs(base + v);
    if (k == 0) return lo;
    const uint4 hi = __ldcs(base + v + 1);  // holds the chunk's last byte, so lies inside the operand's pages
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const int s = k >> 2, sh = 8 * (k & 3);
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x0 = s == 0 ? w[j] : s == 1 ? w[j + 1] : s == 2 ? w[j + 2] : w[j + 3];
      const uint32_t x1 = s == 0 ? w[j + 1] : s == 1 ? w[j + 2] : s == 2 ? w[j + 3] : w[j + 4];
      r[j] = __funnelshift_r(x0, x1, sh);
    }
    return make_uint4(r[0], r[1], r[2], r[3]);
  }
};

// The chunks [0, nv) of a grid-stride pass, two chunks' loads in flight per
// thread; f maps a chunk of a and one of b to one of out (16-byte aligned).
template <typename F>
__device__ __forceinline__ void stream_pass(const Stream& A, const Stream& B, uint4* __restrict__ out, long long nv,
                                            long long tid, long long nthreads, F f) {
  for (long long v = tid; v < nv; v += 2 * nthreads) {
    const long long w = v + nthreads;
    const bool two = w < nv;
    const uint4 x0 = A.chunk(v), y0 = B.chunk(v);
    uint4 x1 = x0, y1 = y0;
    if (two) {
      x1 = A.chunk(w);
      y1 = B.chunk(w);
    }
    __stcs(out + v, f(x0, y0));
    if (two) __stcs(out + w, f(x1, y1));
  }
}

// The chunks [0, nv) of one operand in a grid-stride pass, U chunks' loads
// in flight per thread; f(v, x) writes what chunk v of the operand (x)
// gives. A warp's lanes hold consecutive chunks, so the lanes that call f
// for one u are the whole warp wherever the warp's 32 chunks lie below nv.
template <int U, typename F>
__device__ __forceinline__ void unary_pass(const Stream& A, long long nv, long long tid, long long nthreads, F f) {
  for (long long v = tid; v < nv; v += U * nthreads) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + u * nthreads < nv) x[u] = A.chunk(v + u * nthreads);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + u * nthreads < nv) f(v + u * nthreads, x[u]);
  }
}

// ----------------------------------------------------------------------
// Strided walks (K8, K8-A): operands read in place by element strides
// ----------------------------------------------------------------------
// The output's n elements, in order, as (n / (n1 n2), n1, n2); each operand
// has an element stride along each of the three axes (0 where it is
// broadcast). A thread walks its elements of a grid-stride pass, `step`
// elements apart, by adds: the coordinates (c1, c2) and each operand's
// offset move by the step's digits, and a carry out of an axis adds the
// offset of the wrap. All of it is 64-bit: the outer product of the RS
// decoder alone has 69 M elements, and strides times coordinates can pass
// 2^31 before that.

struct Axes {
  long long n, n1, n2;  // elements; the sizes of the two inner axes
  long long k1, k2;     // the step's digits on axes 1 and 2 (the rest is in each operand's d)
};

struct Strides {
  long long s0, s1, s2;  // element strides
  long long d;           // the offset of one step, carries aside
  long long w2, w1;      // the offset of a wrap of axis 2 (into axis 1), of axis 1 (into axis 0)
};

// The walk of a pass `step` elements a stride (n1, n2 >= 1).
Axes make_axes(long long n, long long n1, long long n2, long long step) {
  return Axes{n, n1, n2, (step / n2) % n1, step % n2};
}

Strides make_strides(long long s0, long long s1, long long s2, const Axes& ax, long long step) {
  const long long k0 = step / (ax.n1 * ax.n2);
  return Strides{s0, s1, s2, k0 * s0 + ax.k1 * s1 + ax.k2 * s2, s1 - ax.n2 * s2, s0 - ax.n1 * s1};
}

struct Coord {
  long long c1, c2;

  __device__ __forceinline__ Coord(long long i, const Axes& ax) {
    const long long t = i / ax.n2;
    c2 = i - t * ax.n2;
    c1 = t % ax.n1;
  }

  // This element's offset in an operand (i: its index in the output).
  __device__ __forceinline__ long long offset(long long i, const Strides& s, const Axes& ax) const {
    return (i / (ax.n1 * ax.n2)) * s.s0 + c1 * s.s1 + c2 * s.s2;
  }

  // One step on: the carries as 0/1, for each operand's advance().
  __device__ __forceinline__ void step(const Axes& ax, bool& carry2, bool& carry1) {
    c2 += ax.k2;
    carry2 = c2 >= ax.n2;
    if (carry2) c2 -= ax.n2;
    c1 += ax.k1 + carry2;
    carry1 = c1 >= ax.n1;
    if (carry1) c1 -= ax.n1;
  }
};

__device__ __forceinline__ void advance(long long& off, const Strides& s, bool carry2, bool carry1) {
  off += s.d + (carry2 ? s.w2 : 0) + (carry1 ? s.w1 : 0);
}

// 1 where an operand is laid out as the output, (n0, n1, n2) contiguous;
// 0 where it is one element (stride 0 along every axis of more than one);
// -1 otherwise. An operand of 1 or 0 is read at offset i * unit.
int flat_unit(long long s0, long long s1, long long s2, long long n0, long long n1, long long n2) {
  if ((n0 == 1 || s0 == 0) && (n1 == 1 || s1 == 0) && (n2 == 1 || s2 == 0)) return 0;
  if ((n2 == 1 || s2 == 1) && (n1 == 1 || s1 == n2) && (n0 == 1 || s0 == n1 * n2)) return 1;
  return -1;
}

// ----------------------------------------------------------------------
// The bytes placement: rows of four bytes, one copy per bank
// ----------------------------------------------------------------------

constexpr int BYTE_THREADS = 256;
constexpr unsigned ROW = 128;  // bytes of one table row: 32 lanes of 4 bytes

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// 0xFF in each byte of w that is not 0, 0x00 in each that is.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t t = ((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w;  // bit 7 of a byte: the byte is not 0
  return prmt(t, 0, 0xBA98);  // each byte filled with its bit 7
}

// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t pack_bytes(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  return prmt(prmt(r0, r1, 0x0040), prmt(r2, r3, 0x0040), 0x5410);
}

// The first `rows` words of rows_g into shared memory, each word four
// times, so that row r of lane l is the word r * 32 + l and the 32 lanes of
// a warp always read 32 different banks; then a barrier. A lane's column
// is s_rows + 4 * (lane), and a table read is one byte load at
// col + ROW * r + field.
__device__ __forceinline__ void stage_byte_rows(uint4* s_rows, const uint32_t* __restrict__ rows_g, int rows,
                                                int threads) {
  for (int i = threadIdx.x; i < rows * 8; i += threads) {
    const uint32_t w = __ldg(rows_g + (i >> 3));
    s_rows[i] = make_uint4(w, w, w, w);
  }
  __syncthreads();
}

// The first `entries` uint16 entries of src (a multiple of 8, 16-byte
// aligned) into shared memory; then a barrier.
__device__ __forceinline__ void stage_u16(uint4* s_tab, const uint16_t* __restrict__ src, int entries, int threads) {
  for (int i = threadIdx.x; i < entries / 8; i += threads) s_tab[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
  __syncthreads();
}

// One element from this lane's column (fields: 0 LOG, 1 EXP, 2 (q-1) - LOG),
// before the zero test.
template <int OP>
__device__ __forceinline__ uint32_t byte_op(const uint8_t* col, uint32_t x, uint32_t y) {
  const uint32_t s = col[x * ROW] + col[y * ROW + (OP == OP_MUL ? 0 : 2)];
  return col[s * ROW + 1];
}

// Four elements of one 32-bit word of a and of b.
template <int OP>
__device__ __forceinline__ uint32_t word_op(const uint8_t* col, uint32_t A, uint32_t B) {
  uint32_t r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = byte_op<OP>(col, (A >> (8 * k)) & 0xFF, (B >> (8 * k)) & 0xFF);
  const uint32_t w = pack_bytes(r[0], r[1], r[2], r[3]);
  return w & (OP == OP_MUL ? nonzero_bytes(A) & nonzero_bytes(B) : nonzero_bytes(A));
}

// Four elements of one 32-bit word, each one byte read from this lane's
// column (col points at the field read).
__device__ __forceinline__ uint32_t word_lookup(const uint8_t* col, uint32_t w) {
  uint32_t r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = col[((w >> (8 * k)) & 0xFF) * ROW];
  return pack_bytes(r[0], r[1], r[2], r[3]);
}

template <int PLACE>
__host__ __device__ constexpr int wide_threads() {
  return PLACE == PLACE_LOG_SHARED ? 1024 : 512;
}

// ----------------------------------------------------------------------
// K5/K6: one table read an element
// ----------------------------------------------------------------------
// ZERO: 0 maps to 0 (K8-A's reciprocal); K5 leaves that test to its callers
// and reads INV[0] = 1.

// bytes placement: rows_g is pack_tables' byte rows, of which the first q
// are staged. K5 writes uint8 INV[a] (byte 3), K6 int64 LOG[a] (byte 0).
// Four chunks in flight a thread: on an H100 K5 took 0.051-0.052 ms at
// 2^26 so, 0.054 ms with two (a cap of 64 registers for four blocks a SM
// gained nothing and spilled). The int64 kernels ran best with one.
template <int OP, bool ZERO = false>
__global__ void __launch_bounds__(BYTE_THREADS)
bytes_unary_kernel(const uint8_t* __restrict__ a, void* __restrict__ out, const uint32_t* __restrict__ rows_g,
                   int q, long long n) {
  extern __shared__ uint4 s_rows[];  // q rows x 32 lanes x 4 bytes
  stage_byte_rows(s_rows, rows_g, q, BYTE_THREADS);
  const uint8_t* col = reinterpret_cast<const uint8_t*>(s_rows) + 4 * (threadIdx.x & 31) + (OP == OP_RECIP ? 3 : 0);
  const long long tid = static_cast<long long>(blockIdx.x) * BYTE_THREADS + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * BYTE_THREADS;
  const Stream A(a, false, make_uint4(0, 0, 0, 0));
  const long long nv = n >> 4;
  uint4* o = static_cast<uint4*>(out);
  if constexpr (OP == OP_RECIP) {
    auto f = [col](uint32_t w) { return ZERO ? word_lookup(col, w) & nonzero_bytes(w) : word_lookup(col, w); };
    unary_pass<4>(A, nv, tid, nthreads, [f, o](long long v, uint4 x) {
      __stcs(o + v, make_uint4(f(x.x), f(x.y), f(x.z), f(x.w)));
    });
    for (long long i = (nv << 4) + tid; i < n; i += nthreads)  // the ragged tail
      static_cast<uint8_t*>(out)[i] = ZERO && a[i] == 0 ? 0 : col[a[i] * ROW];
  } else {
    // Sixteen LOG bytes a lane, then eight 16-byte int64 stores. A whole
    // warp (32 chunks, 512 elements) stores them transposed: store j of lane
    // l holds elements 2(32j + l) and 2(32j + l) + 1 of the warp's group,
    // bytes 2(l % 8) and 2(l % 8) + 1 of lane 4j + l / 8's LOG bytes, so
    // each store instruction writes 512 contiguous bytes (each lane storing
    // its own chunk's eight, 128 bytes apart from the next lane's, took 0.23
    // ms at 2^24 on an H100, four times as long). The last, partial warp of
    // the pass stores each lane's own chunk.
    const int lane = threadIdx.x & 31;
    unary_pass<4>(A, nv, tid, nthreads, [col, o, nv, lane](long long v, uint4 x) {
      const uint32_t r[4] = {word_lookup(col, x.x), word_lookup(col, x.y), word_lookup(col, x.z),
                             word_lookup(col, x.w)};
      const long long first = v - lane;  // the warp's first chunk
      if (first + 32 <= nv) {  // the same for every lane of the warp
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int src = 4 * j + (lane >> 3), k = (lane & 7) >> 1;
          const uint32_t w0 = __shfl_sync(0xFFFFFFFFu, r[0], src), w1 = __shfl_sync(0xFFFFFFFFu, r[1], src);
          const uint32_t w2 = __shfl_sync(0xFFFFFFFFu, r[2], src), w3 = __shfl_sync(0xFFFFFFFFu, r[3], src);
          const uint32_t h = (k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3) >> (16 * (lane & 1));
          __stcs(o + 8 * first + 32 * j + lane, make_uint4(h & 0xFF, 0, (h >> 8) & 0xFF, 0));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // elements 2j and 2j + 1 of this lane's chunk
          const uint32_t h = r[j >> 1] >> (16 * (j & 1));
          __stcs(o + 8 * v + j, make_uint4(h & 0xFF, 0, (h >> 8) & 0xFF, 0));
        }
      }
    });
    for (long long i = (nv << 4) + tid; i < n; i += nthreads)
      static_cast<int64_t*>(out)[i] = col[a[i] * ROW];
  }
}

// int64 placements: seg is the staged uint16 segment of pack_tables'
// table (INV for K5, LOG for K6; `staged` entries, 0 for global), or for
// global the int32 tables. Writes int64 INV[a] (K5) or LOG[a] (K6).
template <int OP, int PLACE, bool ZERO = false>
__global__ void __launch_bounds__(PLACE == PLACE_LOG_SHARED ? 1024 : 512, PLACE == PLACE_LOG_SHARED ? 1 : 2)
wide_unary_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, const uint16_t* __restrict__ seg,
                  int staged, const int32_t* __restrict__ exp32, const int32_t* __restrict__ log32, int q,
                  long long n) {
  constexpr int THREADS = wide_threads<PLACE>();
  extern __shared__ uint4 s_tab[];
  stage_u16(s_tab, seg, staged, THREADS);
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(s_tab);
  const int q1 = q - 1;
  // one element: x is the low word of an int64 storage value in [0, q)
  auto f = [s16, exp32, log32, q1](uint32_t x) -> uint32_t {
    if (ZERO && x == 0) return 0;
    if constexpr (PLACE == PLACE_GLOBAL) {
      const int l = __ldg(log32 + x);
      return OP == OP_RECIP ? __ldg(exp32 + (q1 - l)) : l;
    } else {
      return s16[x];
    }
  };
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * THREADS;
  const Stream A(a, false, make_uint4(0, 0, 0, 0));
  const long long nv = n >> 1;
  uint4* o = reinterpret_cast<uint4*>(out);
  unary_pass<1>(A, nv, tid, nthreads, [f, o](long long v, uint4 x) { __stcs(o + v, make_uint4(f(x.x), 0, f(x.z), 0)); });
  for (long long i = (nv << 1) + tid; i < n; i += nthreads)  // the ragged tail
    out[i] = f(static_cast<uint32_t>(a[i]));
}

template <int OP, bool ZERO = false>
cudaError_t launch_unary(int place, const void* a, void* out, const void* packed, const int32_t* exp_t,
                         const int32_t* log_t, int q, long long n, cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t err;
  if (place == PLACE_BYTES) {
    const int smem = q * static_cast<int>(ROW);
    auto kernel = bytes_unary_kernel<OP, ZERO>;
    if ((err = persistent_grid(kernel, BYTE_THREADS, smem, n / 16 + 1, &blocks)) != cudaSuccess) return err;
    kernel<<<blocks, BYTE_THREADS, smem, stream>>>(static_cast<const uint8_t*>(a), out,
                                                    static_cast<const uint32_t*>(packed), q, n);
    return cudaGetLastError();
  }
  const int q8 = round8(q), e8 = round8(q - 1);
  const int64_t* a64 = static_cast<const int64_t*>(a);
  int64_t* o64 = static_cast<int64_t*>(out);
  // INV at q8 + e8 (K5) or LOG at 0 (K6) of the uint16 placements' table
  const uint16_t* seg = packed ? static_cast<const uint16_t*>(packed) + (OP == OP_RECIP ? q8 + e8 : 0) : nullptr;
#define LAUNCH_WIDE_UNARY(PLACE, STAGED)                                                                 \
  do {                                                                                                   \
    auto kernel = wide_unary_kernel<OP, PLACE, ZERO>;                                                    \
    const int staged = (STAGED), smem = 2 * staged, threads = wide_threads<PLACE>();                     \
    if ((err = persistent_grid(kernel, threads, smem, n / 2 + 1, &blocks)) != cudaSuccess) return err;  \
    kernel<<<blocks, threads, smem, stream>>>(a64, o64, seg, staged, exp_t, log_t, q, n);                \
    return cudaGetLastError();                                                                           \
  } while (0)
  switch (place) {
    case PLACE_SHARED: LAUNCH_WIDE_UNARY(PLACE_SHARED, q8);
    case PLACE_LOG_SHARED: LAUNCH_WIDE_UNARY(PLACE_LOG_SHARED, q8);
    case PLACE_GLOBAL: LAUNCH_WIDE_UNARY(PLACE_GLOBAL, 0);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH_WIDE_UNARY
}

}  // namespace
