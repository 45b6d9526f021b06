// Kernels K12 and K13: the two scans of lfsr.py, each one launch of one CTA,
// over the int-storage fields of field_scan.cuh; every kernel is templated
// on the field's kind (and K12's on the register's mode), so that no inner
// loop branches on either. Wrappers and plain torch versions:
// ops/_lfsr_scan.py. Storage: uint8 for orders <= 2^8, int64 above (the
// port's int storage), read and written through 32-bit registers.
//
// K12, lfsr_step: n ticks of one shift register of order k (its taps),
// replacing the four lax.scan tick functions of galois_tpu/lfsr.py:63-106
// (Fibonacci and Galois, forward and backward). Every mode is a linear map
// of the state, s -> A s, with a linear output o s; B = 32 ticks are
// therefore fixed matrices of the taps and the mode: the B x k matrix D whose
// rows are the block's outputs o A^j (Galois) or its new state elements
// (Fibonacci), and for Galois the k x min(B, k) columns G of A^B that the
// shift by B does not cover. The wrapper builds them by one launch of this
// kernel on a batch of k registers (one CTA each) from the basis states,
// B ticks tick by tick, and a register keeps them between calls
// (ops/_lfsr_scan.py::_blocks; block_matrices is the same by the plain tick
// loop on the identity). For k <= 1024, thread i holds state element i
// (k <= 32: one warp, the matrices' entries in registers; above, up to 32
// warps read them through L1 each block), and one block of B ticks is:
//   1. thread (w, l) sums its share of D's row l against the state (a
//      k-term dot split over the warps, then one shared slot a warp); for
//      Galois, thread i < k also sums row i of G against the B elements that
//      leave the register;
//   2. one barrier (a warp barrier for k <= 32);
//   3. warp 0 writes the B outputs in one coalesced store; thread i writes
//      its new state element: the element B places along (Fibonacci
//      forward: i - B, backward: i + B) or a new one from step 1; Galois
//      adds its G sum to the shifted element;
//   4. one barrier.
// The factors in step 1 are prepared once a block (the LOG of each element
// for the table kinds, so that a product is one EXP read, from shared memory
// for q <= 1024). GF(2) up to 32 taps packs instead: the state is one word
// in every lane, lane l's row of D (and of G) a mask of k bits, each dot the
// parity of a popc, and a ballot gathers the block's 32 results into the
// outputs and the next state word (Fibonacci forward: bit-reversed); no
// shared memory and no barrier. Fewer than 2B
// ticks, and the last n mod B, run tick by tick: per tick
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
// Above 1024 taps (a long Berlekamp-Massey result has order N / 2) the
// register runs tick by tick only: the state's two buffers and the taps
// live in shared memory while 12 k bytes fit (k <= 19,008), else in global
// scratch from the wrapper, and each of 1024 threads takes every 1024th
// element. Each tick's output goes into a shared-memory stage of OUT_CHUNK
// elements, written out a chunk at a time. What bounds K12: the chain of
// dependent steps of a block (its dots' products, two barriers; over GF(2)
// up to 32 taps a popc and one or two ballots) or of a tick (a reduction or
// a broadcast, then the shift); bytes are no bound. On "NVIDIA H100 80GB
// HBM3, 700.00 W" a block of 32 ticks takes about 0.04 us over GF(2) with 20
// taps (0.0012-0.0015 us a tick), 1.26 us over GF(2^8) with 32 taps
// (Galois) and 2.1 us over GF(2^31 - 1) with 16; the tick-by-tick form at
// 8192 taps 2.0 us a tick (PERF.md section 6).
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
// complexity N / 2, spread over 1024 threads (1.29 us a step over GF(2) at
// N = 2^14 on "NVIDIA H100 80GB HBM3, 700.00 W").

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_scan.cuh"

namespace {

using field_scan::Arith;
using field_scan::Field;

constexpr int BM_THREADS = 1024;
constexpr int BLK = 32;          // K12's ticks a block
constexpr int OUT_CHUNK = 1024;  // K12's staged outputs of the tick loop
constexpr int EXP_SMEM = 4096;   // K12 stages a table field's extended EXP in shared memory up to this
                                 // many entries (q <= 1024)
constexpr size_t SMEM_LIMIT = 227 * 1024;
// K12 above 1024 taps: two state buffers and the taps, beside the stage
constexpr size_t wide_bytes(long long k) { return 3 * static_cast<size_t>(k) * sizeof(uint32_t); }
constexpr bool wide_in_smem(long long k) { return wide_bytes(k) + (OUT_CHUNK + 64) * sizeof(uint32_t) <= SMEM_LIMIT; }

enum Mode : int { FIB_FWD = 0, FIB_BWD = 1, GAL_FWD = 2, GAL_BWD = 3 };

// Storage: uint8 where bytes, else int64.
__device__ __forceinline__ uint32_t ld(const void* p, long long i, int bytes) {
  return bytes ? static_cast<uint32_t>(static_cast<const uint8_t*>(p)[i])
               : static_cast<uint32_t>(static_cast<const long long*>(p)[i]);
}

__device__ __forceinline__ void st(void* p, long long i, uint32_t v, int bytes) {
  if (bytes) {
    static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v);
  } else {
    static_cast<long long*>(p)[i] = static_cast<long long>(v);
  }
}

// Element i of a storage array.
__device__ __forceinline__ void* elem(void* p, long long i, int bytes) {
  return bytes ? static_cast<void*>(static_cast<uint8_t*>(p) + i) : static_cast<void*>(static_cast<long long*>(p) + i);
}

struct Block {
  uint32_t* part;  // one slot a warp
  uint32_t* edge;  // one slot a warp: a warp's last (or first) lane
  int lane, warp, nw;
};

template <int K>
__device__ __forceinline__ uint32_t warp_sum(const Field& F, uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = Arith<K>::add(F, v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The field sum of v over the block, in every thread.
template <int K>
__device__ __forceinline__ uint32_t block_sum(const Field& F, const Block& B, uint32_t v) {
  v = warp_sum<K>(F, v);
  if (B.nw == 1) return v;
  if (B.lane == 0) B.part[B.warp] = v;
  __syncthreads();
  uint32_t s = B.part[0];
  for (int w = 1; w < B.nw; ++w) s = Arith<K>::add(F, s, B.part[w]);
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
__device__ __forceinline__ void emit(uint32_t* stage, void* out, int bytes, long long t, long long steps, bool writer,
                                     uint32_t v) {
  const int slot = static_cast<int>(t % OUT_CHUNK);
  if (writer) stage[slot] = v;
  if (slot == OUT_CHUNK - 1 || t == steps - 1) {
    __syncthreads();
    for (int j = threadIdx.x; j <= slot; j += blockDim.x) st(out, t - slot + j, stage[j], bytes);
    __syncthreads();
  }
}

// One warp: the coefficients in registers; up to 32 warps: read through L1.
template <bool ONE_WARP>
struct Coefs;

template <>
struct Coefs<true> {
  uint32_t d[BLK], g[BLK];
  __device__ __forceinline__ void load(const uint32_t* __restrict__ D, const uint32_t* __restrict__ G, int tid) {
#pragma unroll
    for (int r = 0; r < BLK; ++r) {
      d[r] = __ldg(D + r * BLK + tid);
      g[r] = G ? __ldg(G + r * BLK + tid) : 0u;
    }
  }
  __device__ __forceinline__ uint32_t dc(int r, int) const { return d[r]; }
  __device__ __forceinline__ uint32_t gc(int r, int) const { return g[r]; }
};

template <>
struct Coefs<false> {
  const uint32_t* D;
  const uint32_t* G;
  int nt;
  __device__ __forceinline__ void load(const uint32_t* __restrict__ D_, const uint32_t* __restrict__ G_, int) {
    D = D_;
    G = G_;
    nt = blockDim.x;
  }
  __device__ __forceinline__ uint32_t dc(int r, int tid) const { return __ldg(D + r * nt + tid); }
  __device__ __forceinline__ uint32_t gc(int r, int tid) const { return __ldg(G + r * nt + tid); }
};

// K12 for k <= 1024: nblk blocks of BLK ticks by the matrices D (and G),
// then the rest of the steps tick by tick. D and G are laid out so that
// thread tid's r-th entry is at r * blockDim + tid (ops/_lfsr_scan.py).
template <int KIND, int MODE, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : 1024)
    lfsr_kernel(const void* __restrict__ state, const void* __restrict__ taps, void* __restrict__ state_out,
                void* __restrict__ out, int bytes, long long steps, int k, uint32_t inv_tap, Field F,
                const uint32_t* __restrict__ D, const uint32_t* __restrict__ G, long long nblk) {
  using A = Arith<KIND>;
  // CTA r runs register r of a batch (tick by tick only: nblk = 0 when there are several): its
  // state and new state at r k, its outputs at r steps
  const long long reg = blockIdx.x;
  constexpr bool GALOIS = MODE == GAL_FWD || MODE == GAL_BWD;
  constexpr bool TABLES = KIND == field_scan::BINTAB || KIND == field_scan::ODDTAB;
  __shared__ uint32_t sv[2][1024], ps[2][1024], part[32][32], bpart[32], edge[32], stage[OUT_CHUNK];
  __shared__ int exp_s[TABLES ? EXP_SMEM : 1];
  const int i = threadIdx.x, w = i >> 5, l = i & 31, nw = static_cast<int>(blockDim.x) >> 5;
  const bool live = i < k;
  if (TABLES && 4 * F.q1 + 1 <= EXP_SMEM) {  // the extended EXP in shared memory
    for (int j = i; j <= 4 * static_cast<int>(F.q1); j += blockDim.x) exp_s[j] = __ldg(F.exp + j);
    __syncthreads();
    F.exp = exp_s;
  }
  uint32_t s = live ? ld(state, reg * k + i, bytes) : 0u;
  if constexpr (KIND == field_scan::GF2 && ONE_WARP) {
    if (nblk > 0) {
      // GF(2), k <= 32: the state as one word in every lane (bit j: element j), lane l's row of D
      // and of G as masks of k bits; each dot is the parity of a popc, a ballot gathers the block's
      // 32 results, and no shared memory or barrier is touched
      const uint32_t kmask = k == 32 ? 0xffffffffu : (1u << k) - 1u;
      uint32_t dm = 0, gm = 0;
#pragma unroll
      for (int r = 0; r < BLK; ++r) {
        dm |= (__ldg(D + r * BLK + i) & 1u) << r;
        if (GALOIS) gm |= (__ldg(G + r * BLK + i) & 1u) << r;
      }
      uint32_t S = __ballot_sync(0xffffffffu, s & 1u) & kmask;
      for (long long b = 0; b < nblk; ++b) {
        const uint32_t Ab = __ballot_sync(0xffffffffu, __popc(dm & S) & 1u);
        uint32_t o;
        if (MODE == FIB_FWD) {  // outputs: the old state from element k - 1 down, then the fresh elements
          o = l < k ? (S >> (k - 1 - l)) & 1u : (Ab >> (l - k)) & 1u;
          S = __brev(Ab) & kmask;
        } else if (MODE == FIB_BWD) {
          o = (Ab >> l) & 1u;
          S = (Ab >> (BLK - k)) & kmask;
        } else {  // Galois: every element leaves (k <= B); the new state is G's dots
          o = (Ab >> l) & 1u;
          S = __ballot_sync(0xffffffffu, __popc(gm & S) & 1u) & kmask;
        }
        st(out, b * BLK + l, o, bytes);
      }
      s = live ? (S >> i) & 1u : 0u;
    }
  } else if (nblk > 0) {
    Coefs<ONE_WARP> C;
    C.load(D, G, i);
    const int cw = k < BLK ? k : BLK;
    const int col0 = MODE == GAL_FWD ? k - cw : 0;
    if (live) {
      sv[0][i] = s;
      ps[0][i] = A::prep(F, s);
    }
    __syncthreads();
    for (long long b = 0; b < nblk; ++b) {
      const int cur = static_cast<int>(b & 1), nxt = cur ^ 1;
      // 1. this thread's share of D's row l; Galois: row i of G
      uint32_t acc = 0, g = 0;
#pragma unroll
      for (int r = 0; r < BLK; ++r) {
        const int idx = w + nw * r;
        if (idx < k) acc = A::add(F, acc, A::mulp(F, C.dc(r, i), ps[cur][idx]));
      }
      if (GALOIS && live) {
#pragma unroll
        for (int c = 0; c < BLK; ++c) {
          if (c < cw) g = A::add(F, g, A::mulp(F, C.gc(c, i), ps[cur][col0 + c]));
        }
      }
      if (!ONE_WARP) {
        part[w][l] = acc;
        __syncthreads();
        if (w == 0) {
          acc = part[0][l];
          for (int v = 1; v < nw; ++v) acc = A::add(F, acc, part[v][l]);
        }
      }
      // 3. outputs (warp 0) and the new state
      uint32_t* out_sv = sv[nxt];
      uint32_t* out_ps = ps[nxt];
      const long long t0 = b * BLK;
      if (MODE == FIB_FWD) {
        if (w == 0) {
          const uint32_t fresh = __shfl_sync(0xffffffffu, acc, l >= k ? l - k : 0);
          st(out, t0 + l, l < k ? sv[cur][k - 1 - l] : fresh, bytes);
          if (l >= BLK - k) {
            out_sv[BLK - 1 - l] = acc;
            out_ps[BLK - 1 - l] = A::prep(F, acc);
          }
        }
        if (i >= BLK && live) {
          out_sv[i] = sv[cur][i - BLK];
          out_ps[i] = ps[cur][i - BLK];
        }
      } else if (MODE == FIB_BWD) {
        if (w == 0) {
          st(out, t0 + l, acc, bytes);
          if (l >= BLK - k) {
            out_sv[k - BLK + l] = acc;
            out_ps[k - BLK + l] = A::prep(F, acc);
          }
        }
        if (i < k - BLK) {
          out_sv[i] = sv[cur][i + BLK];
          out_ps[i] = ps[cur][i + BLK];
        }
      } else {
        if (w == 0) st(out, t0 + l, acc, bytes);
        if (live) {
          uint32_t v = 0;
          if (MODE == GAL_FWD) {
            if (i >= BLK) v = sv[cur][i - BLK];
          } else {
            if (i + BLK < k) v = sv[cur][i + BLK];
          }
          v = A::add(F, v, g);
          out_sv[i] = v;
          out_ps[i] = A::prep(F, v);
        }
      }
      __syncthreads();
    }
    s = live ? sv[nblk & 1][i] : 0u;
  }
  // the rest tick by tick
  const long long done = nblk * BLK, rest = steps - done;
  void* out_rest = elem(out, reg * steps + done, bytes);
  const Block Bk{bpart, edge, l, w, nw};
  const uint32_t tp = live ? ld(taps, i, bytes) : 0u;
  const uint32_t tp_prev = shift_up(Bk, tp, 0u);  // tap i - 1, for the Fibonacci backward dot
  for (long long t = 0; t < rest; ++t) {
    if (MODE == FIB_FWD) {
      const uint32_t d = block_sum<KIND>(F, Bk, A::mul(F, s, tp));
      emit(stage, out_rest, bytes, t, rest, i == k - 1, s);
      s = shift_up(Bk, s, d);
    } else if (MODE == GAL_FWD) {
      const uint32_t f = from(Bk, s, k - 1);
      emit(stage, out_rest, bytes, t, rest, i == 0, f);
      s = A::add(F, shift_up(Bk, s, 0u), A::mul(F, f, tp));
    } else if (MODE == FIB_BWD) {
      const uint32_t dot = block_sum<KIND>(F, Bk, A::mul(F, s, tp_prev));
      const uint32_t sv0 = A::mul(F, A::sub(F, from(Bk, s, 0), dot), inv_tap);
      emit(stage, out_rest, bytes, t, rest, i == 0, sv0);
      s = shift_down(Bk, s, sv0, k);
    } else {
      const uint32_t f = A::mul(F, from(Bk, s, 0), inv_tap);
      emit(stage, out_rest, bytes, t, rest, i == 0, f);
      s = shift_down(Bk, A::sub(F, s, A::mul(F, f, tp)), f, k);
    }
  }
  if (live) st(state_out, reg * k + i, s, bytes);
}

// K12 for k > 1024: the state (two buffers, one a tick) and the taps in
// shared memory (SMEM) or in the wrapper's global scratch of 3 k uint32,
// 1024 threads each taking elements j = tid, tid + 1024, ...; the barrier
// that ends a tick makes its writes, shared or global, visible to the next.
template <int KIND, int MODE, bool SMEM>
__global__ void __launch_bounds__(1024) lfsr_wide_kernel(const void* __restrict__ state, const void* __restrict__ taps,
                                                         void* __restrict__ state_out, void* __restrict__ out,
                                                         int bytes, long long steps, int k, uint32_t inv_tap,
                                                         uint32_t* __restrict__ scratch, Field F) {
  using A = Arith<KIND>;
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t part[32], edge[32], stage[OUT_CHUNK];
  const int tid = threadIdx.x, nt = blockDim.x;
  const Block B{part, edge, tid & 31, tid >> 5, nt >> 5};
  uint32_t* base = SMEM ? smem : scratch;
  uint32_t* buf[2] = {base, base + k};
  uint32_t* tp = base + 2 * k;
  for (int j = tid; j < k; j += nt) {
    buf[0][j] = ld(state, j, bytes);
    tp[j] = ld(taps, j, bytes);
  }
  __syncthreads();
  for (long long t = 0; t < steps; ++t) {
    const uint32_t* cur = buf[t & 1];
    uint32_t* nxt = buf[(t + 1) & 1];
    if (MODE == FIB_FWD) {
      uint32_t acc = 0;
      for (int j = tid; j < k; j += nt) acc = A::add(F, acc, A::mul(F, cur[j], tp[j]));
      const uint32_t d = block_sum<KIND>(F, B, acc);
      emit(stage, out, bytes, t, steps, tid == 0, cur[k - 1]);
      for (int j = tid; j < k; j += nt) nxt[j] = j ? cur[j - 1] : d;
    } else if (MODE == GAL_FWD) {
      const uint32_t f = cur[k - 1];
      emit(stage, out, bytes, t, steps, tid == 0, f);
      for (int j = tid; j < k; j += nt) nxt[j] = A::add(F, j ? cur[j - 1] : 0u, A::mul(F, f, tp[j]));
    } else if (MODE == FIB_BWD) {
      uint32_t acc = 0;
      for (int j = tid + 1; j < k; j += nt) acc = A::add(F, acc, A::mul(F, cur[j], tp[j - 1]));
      const uint32_t sv = A::mul(F, A::sub(F, cur[0], block_sum<KIND>(F, B, acc)), inv_tap);
      emit(stage, out, bytes, t, steps, tid == 0, sv);
      for (int j = tid; j < k; j += nt) nxt[j] = j + 1 < k ? cur[j + 1] : sv;
    } else {
      const uint32_t f = A::mul(F, cur[0], inv_tap);
      emit(stage, out, bytes, t, steps, tid == 0, f);
      for (int j = tid; j < k; j += nt) nxt[j] = j + 1 < k ? A::sub(F, cur[j + 1], A::mul(F, f, tp[j + 1])) : f;
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += nt) st(state_out, j, buf[steps & 1][j], bytes);
}

template <int KIND, typename T, bool SMEM>
__global__ void __launch_bounds__(BM_THREADS) bm_long_kernel(const T* __restrict__ seq, long long N,
                                                             T* __restrict__ c_out, long long* __restrict__ L_out,
                                                             uint32_t* __restrict__ scratch, Field F) {
  using A = Arith<KIND>;
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
      acc = A::add(F, acc, A::mul(F, c[j], static_cast<uint32_t>(seq[t - j])));
    }
    const uint32_t d = block_sum<KIND>(F, B, acc);
    if (d == 0) {
      ++m;
      continue;
    }
    const uint32_t coef = A::mul(F, d, inv_b);
    long long next = ext_c > m + ext_b ? ext_c : m + ext_b;
    if (next > K - 1) next = K - 1;
    const uint32_t* b = buf[bi];
    if (2 * L <= t) {  // L grows: c_new into the spare, the old c becomes b
      uint32_t* tmp = buf[ti];
      for (long long j = tid; j <= next; j += BM_THREADS) {
        uint32_t v = c[j];
        if (j >= m && j - m <= ext_b) v = A::sub(F, v, A::mul(F, coef, b[j - m]));
        tmp[j] = v;
      }
      __syncthreads();
      const int old_b = bi;
      bi = ci;
      ci = ti;
      ti = old_b;
      ext_b = ext_c;
      inv_b = A::inv(F, d);
      L = t + 1 - L;
      m = 1;
    } else {
      uint32_t* cw = buf[ci];
      for (long long j = m + tid; j <= m + ext_b && j < K; j += BM_THREADS) {
        cw[j] = A::sub(F, cw[j], A::mul(F, coef, b[j - m]));
      }
      __syncthreads();
      ++m;
    }
    ext_c = next;
  }
  for (long long j = tid; j < K; j += BM_THREADS) c_out[j] = static_cast<T>(buf[ci][j]);
  if (tid == 0) *L_out = L;
}

template <int KIND, int MODE>
cudaError_t launch_lfsr(const void* state, const void* taps, void* state_out, void* out, int bytes, long long steps,
                        int k, uint32_t inv_tap, uint32_t* scratch, const Field& F, const uint32_t* D,
                        const uint32_t* G, long long nblk, int nregs, cudaStream_t s) {
  if (k <= 1024) {
    const int threads = (k + 31) / 32 * 32;
    if (threads == 32) {
      lfsr_kernel<KIND, MODE, true><<<nregs, 32, 0, s>>>(state, taps, state_out, out, bytes, steps, k, inv_tap, F, D,
                                                         G, nblk);
    } else {
      lfsr_kernel<KIND, MODE, false><<<nregs, threads, 0, s>>>(state, taps, state_out, out, bytes, steps, k, inv_tap,
                                                               F, D, G, nblk);
    }
    return cudaGetLastError();
  }
  if (wide_in_smem(k)) {
    const size_t nbytes = wide_bytes(k);
    auto kernel = lfsr_wide_kernel<KIND, MODE, true>;
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
    if (e != cudaSuccess) return e;
    kernel<<<1, 1024, nbytes, s>>>(state, taps, state_out, out, bytes, steps, k, inv_tap, nullptr, F);
  } else {
    if (!scratch) return cudaErrorInvalidValue;
    lfsr_wide_kernel<KIND, MODE, false><<<1, 1024, 0, s>>>(state, taps, state_out, out, bytes, steps, k, inv_tap,
                                                           scratch, F);
  }
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_lfsr_mode(int mode, const void* state, const void* taps, void* state_out, void* out, int bytes,
                             long long steps, int k, uint32_t inv_tap, uint32_t* scratch, const Field& F,
                             const uint32_t* D, const uint32_t* G, long long nblk, int nregs, cudaStream_t s) {
  switch (mode) {
    case FIB_FWD:
      return launch_lfsr<KIND, FIB_FWD>(state, taps, state_out, out, bytes, steps, k, inv_tap, scratch, F, D, G, nblk,
                                        nregs, s);
    case FIB_BWD:
      return launch_lfsr<KIND, FIB_BWD>(state, taps, state_out, out, bytes, steps, k, inv_tap, scratch, F, D, G, nblk,
                                        nregs, s);
    case GAL_FWD:
      return launch_lfsr<KIND, GAL_FWD>(state, taps, state_out, out, bytes, steps, k, inv_tap, scratch, F, D, G, nblk,
                                        nregs, s);
    default:
      return launch_lfsr<KIND, GAL_BWD>(state, taps, state_out, out, bytes, steps, k, inv_tap, scratch, F, D, G, nblk,
                                        nregs, s);
  }
}

template <int KIND, typename T>
cudaError_t launch_bm(const void* seq, long long N, void* c_out, long long* L_out, uint32_t* scratch,
                      const Field& F, cudaStream_t s) {
  const size_t bytes = 3 * static_cast<size_t>(N + 1) * sizeof(uint32_t);
  if (bytes + 512 <= SMEM_LIMIT) {
    auto kernel = bm_long_kernel<KIND, T, true>;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
    }
    kernel<<<1, BM_THREADS, bytes, s>>>(static_cast<const T*>(seq), N, static_cast<T*>(c_out), L_out, nullptr, F);
  } else {
    if (!scratch) return cudaErrorInvalidValue;
    bm_long_kernel<KIND, T, false><<<1, BM_THREADS, 0, s>>>(static_cast<const T*>(seq), N, static_cast<T*>(c_out),
                                                            L_out, scratch, F);
  }
  return cudaGetLastError();
}

bool valid_field(int kind, const Field& F) {
  switch (kind) {
    case field_scan::GF2: return F.p == 2 && F.m == 1;
    case field_scan::PRIME: return F.p > 2 && F.m == 1 && F.mu;
    case field_scan::BINARY: return F.p == 2 && F.m >= 2 && F.m <= 32;
    case field_scan::BINTAB:
    case field_scan::ODDTAB:
      return F.exp && F.log && F.q1 < (1u << 16) && F.sent == 2 * F.q1 && (kind == field_scan::BINTAB || F.pinv);
    default: return false;
  }
}

#define SCAN_KINDS(CALL)                                              \
  switch (kind) {                                                      \
    case field_scan::GF2: e = CALL(field_scan::GF2); break;            \
    case field_scan::PRIME: e = CALL(field_scan::PRIME); break;        \
    case field_scan::BINARY: e = CALL(field_scan::BINARY); break;      \
    case field_scan::BINTAB: e = CALL(field_scan::BINTAB); break;      \
    default: e = CALL(field_scan::ODDTAB); break;                      \
  }

}  // namespace

// K12: `steps` ticks of nregs registers with one set of taps (state:
// nregs x k elements, taps: k, contiguous; uint8 storage when byte_storage,
// else int64); mode 0-3 as Mode; kind as field_scan::Kind; state_out
// (nregs x k) and out (nregs x steps) written. D and G: the block form's
// matrices for nblk blocks of 32 ticks (nblk 0: every tick one by one; G
// null but for Galois). nregs > 1 (the wrapper's build of D and G, one
// register a basis state) needs k <= 1024 and nblk 0. scratch: 3 k uint32 of global
// memory, needed when they do not fit in shared memory (lfsr_scratch_needed).
extern "C" int lfsr_step_launch(const void* state, const void* taps, void* state_out, void* out, long long steps,
                                int k, int mode, unsigned inv_tap, unsigned* scratch, int byte_storage, int kind,
                                Field F, const unsigned* D, const unsigned* G, long long nblk, int nregs,
                                void* stream) {
  const bool galois = mode == GAL_FWD || mode == GAL_BWD;
  if (steps <= 0 || k < 1 || mode < 0 || mode > 3 || !valid_field(kind, F) || nblk < 0 || nblk * BLK > steps ||
      (nblk && (k > 1024 || !D || (galois && !G))) || nregs < 1 || (nregs > 1 && (k > 1024 || nblk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define LFSR_CALL(KIND) \
  launch_lfsr_mode<KIND>(mode, state, taps, state_out, out, byte_storage, steps, k, inv_tap, scratch, F, D, G, nblk, \
                         nregs, s)
  SCAN_KINDS(LFSR_CALL)
#undef LFSR_CALL
  return static_cast<int>(e);
}

extern "C" int lfsr_scratch_needed(int k) { return k > 1024 && !wide_in_smem(k); }

// K13: c_out (N + 1) and L_out (1) of the Berlekamp-Massey scan of seq (N);
// scratch: 3 (N + 1) uint32 of global memory, needed when they do not fit in
// shared memory (bm_long_scratch_needed).
extern "C" int bm_long_launch(const void* seq, long long N, void* c_out, long long* L_out, unsigned* scratch,
                              int byte_storage, int kind, Field F, void* stream) {
  if (N < 1 || !valid_field(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define BM_CALL(KIND)                                                              \
  (byte_storage ? launch_bm<KIND, uint8_t>(seq, N, c_out, L_out, scratch, F, s) \
                : launch_bm<KIND, long long>(seq, N, c_out, L_out, scratch, F, s))
  SCAN_KINDS(BM_CALL)
#undef BM_CALL
  return static_cast<int>(e);
}

extern "C" int bm_long_scratch_needed(long long N) {
  return 3 * static_cast<size_t>(N + 1) * sizeof(uint32_t) + 512 > SMEM_LIMIT;
}
