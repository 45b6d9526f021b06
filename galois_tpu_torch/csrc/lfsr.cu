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
// minimal LFSR of a high-complexity sequence is not unique); capacity
// K = N + 1. What bounds it on this card is the chain of N dependent steps:
// each step's d needs the c that the last nonzero d made, and the bytes (the
// sequence in, c out) are no bound. The design shortens the chain in two
// forms, each one CTA, its sequence staged once, reversed, in shared memory
// (a global scratch from the wrapper where it does not fit) and its buffers
// swapped as offsets held in registers:
//   - GF(2), bm_gf2_kernel: 32 steps a block by lookahead, on words of 32
//     elements. The block's 64 dots (c and x^m b against the sequence at its
//     32 offsets: AND, funnel shift, popc parity) come first, on the whole
//     CTA, then one barrier; every thread then runs the 32 scalar steps on
//     two 32-bit words (a popc and a few shifts and XORs a step), and the CTA
//     applies the block's 2 x 2 matrix over GF(2)[x] to c and b as carry-less
//     products. A block holds one barrier and 32 dependent scalar steps.
//   - the other kinds, bm_long_kernel: warp 0 alone runs the steps while c
//     spans fewer than 32 BM_NARROW elements, each step a dot, one warp
//     reduction (one instruction for the XOR kinds, two for GF(p)) and, after
//     an update, a __syncwarp: no block barrier. After a step with d = 0 it
//     takes the next 32 dots of the same c at once (a transpose of the lanes'
//     partials through shared memory) and commits the steps up to the first
//     nonzero d, so a run of zero discrepancies costs a batch per 32 steps.
//     Past the narrow width every warp runs the steps, one barrier a step (the
//     warps' partials double-buffered and folded as a tree). The table kinds'
//     sequence is staged in LOG form and their tables in shared memory, so a
//     product is c's LOG and one EXP read.
// On "NVIDIA H100 80GB HBM3, 700.00 W": GF(2), 2^14 random elements (L = 8192),
// 1.87 ms (0.114 us a step); GF(2^8), 8192 outputs of a register with L = 32,
// 0.26 ms; GF(2^31 - 1), 4096 with L = 16, 0.26 ms; the CTA-wide form of random
// sequences 1.3-29 us a step (PERF.md section 6, scripts/scan_limb_timing.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_scan.cuh"

namespace {

using field_scan::Arith;
using field_scan::Field;

constexpr int BM_THREADS = 512;        // K13's largest CTA, where c may outgrow warp 0
constexpr int BM_STAGE_THREADS = 256;  // K13's CTA where warp 0 takes every step (8 warps stage the sequence)
constexpr int BM_MAX_N = 1 << 28;      // K13's longest sequence: its buffers' offsets (4 N + 3) and a GF(2) dot's
                                       // bit offsets (up to 3 N) fit an int
constexpr uint32_t BM_TAB_Q = 1024;    // K13 stages a table field's EXP and LOG in shared memory for q <= this
constexpr int BM_WIDE_UNITS = 8;       // K13's elements a thread at full capacity, where c outgrows warp 0
constexpr int BM_S = 32;               // K13's steps a block (GF(2)) or a batch of zero discrepancies
constexpr int BM_NARROW = 8;           // K13 but over GF(2): warp 0 alone runs the steps while c spans fewer
                                       // than 32 x this many elements
constexpr int BM2_THREADS = 256;       // K13's CTA over GF(2)
constexpr int BLK = 32;          // K12's ticks a block
constexpr int OUT_CHUNK = 1024;  // K12's staged outputs of the tick loop
constexpr int EXP_SMEM = 4096;   // K12 stages a table field's extended EXP in shared memory up to this
                                 // many entries (q <= 1024)
constexpr size_t SMEM_LIMIT = 227 * 1024;
// K13's dynamic shared memory, beside its static arrays (the wrapper may pass a smaller budget)
constexpr size_t BM_SMEM = SMEM_LIMIT - 8 * 1024;
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

// K13's state, the same in every thread that runs the steps. The three buffers are offsets from
// the kernel's base, swapped in registers and never indexed, so that nothing goes to the stack
// and a shared-memory buffer is read by ld.shared.
struct BmState {
  int c;  // the connection polynomial
  int b;  // the one before the last length change
  int s;  // the spare: c - coef x^m b goes there when L grows
  int t, L, m, ext_c, ext_b;  // ext: the highest index that may hold a nonzero
  uint32_t inv_b;             // 1 / bcoef
};

// The table kinds' EXP (extended) and LOG
struct BmTables {
  const int* exp;
  const int* log;
};

// GF(2)'s words of a buffer (N + 1 bits) and of the sequence (a zero word, then N bits, then one more)
__host__ __device__ constexpr int bm2_cw(int N) { return (N + 32) >> 5; }
__host__ __device__ constexpr int bm2_rw(int N) { return ((N + 31) >> 5) + 2; }

__host__ __device__ constexpr bool bm_tables(int kind) {
  return kind == field_scan::BINTAB || kind == field_scan::ODDTAB;
}

// The words of the table kinds' EXP and LOG when they go to shared memory, else 0
__host__ __device__ constexpr int bm_tab_words(int kind, uint32_t q1) {
  return bm_tables(kind) && q1 < BM_TAB_Q ? static_cast<int>(5 * q1 + 2) : 0;
}

// The field sum of v over a warp, in every lane: one instruction for the XOR kinds; two 16-bit halves
// summed by two, then one Barrett step, for GF(p); five shuffles of digit sums for ODDTAB
template <int KIND>
__device__ __forceinline__ uint32_t bm_warp_sum(const Field& F, uint32_t v) {
  if constexpr (KIND == field_scan::BINARY || KIND == field_scan::BINTAB) {
    return __reduce_xor_sync(0xffffffffu, v);
  } else if constexpr (KIND == field_scan::PRIME) {
    const uint32_t lo = __reduce_add_sync(0xffffffffu, v & 0xffffu), hi = __reduce_add_sync(0xffffffffu, v >> 16);
    const uint64_t x = (static_cast<uint64_t>(hi) << 16) + lo;  // < 32 p
    const uint64_t r = x - __umul64hi(x, F.mu) * F.p;
    return static_cast<uint32_t>(r >= F.p ? r - F.p : r);
  } else {
    return warp_sum<KIND>(F, v);
  }
}

// An element's form in a product: its LOG for the table kinds (sent for 0), else itself
template <int KIND>
__device__ __forceinline__ uint32_t bm_prep(const Field& F, const BmTables& T, uint32_t a) {
  if constexpr (bm_tables(KIND)) {
    return a ? static_cast<uint32_t>(T.log[a]) : F.sent;
  } else {
    return a;
  }
}

// The product of two prepared forms: one EXP read for the table kinds
template <int KIND>
__device__ __forceinline__ uint32_t bm_mulp(const Field& F, const BmTables& T, uint32_t x, uint32_t y) {
  if constexpr (bm_tables(KIND)) {
    return static_cast<uint32_t>(T.exp[x + y]);
  } else {
    return Arith<KIND>::mul(F, x, y);
  }
}

constexpr int BM_CHUNK = 4;  // elements a thread loads at once, so that their reads overlap

// The d of step S.t: the dot of c and the sequence's window, on `stride` threads (a warp, or the
// whole CTA when WIDE), this one `id`. Thread id owns the elements j = id mod stride of every buffer:
// it reads them here and is the only one to write them in bm_advance, so that the next dot needs no
// barrier. Each thread takes its elements BM_CHUNK at a time, every read of a chunk issued before
// the arithmetic. WIDE: one barrier, for the warps' partials (double-buffered, folded by every warp).
template <int KIND, bool WIDE>
__device__ __forceinline__ uint32_t bm_dot(const Field& F, const BmTables& T, const BmState& S,
                                           const uint32_t* __restrict__ buf, const uint32_t* __restrict__ rs, int N,
                                           int id, int stride, uint32_t* part, int& par) {
  using A = Arith<KIND>;
  constexpr int U = BM_CHUNK;
  const uint32_t* c = buf + S.c;
  const uint32_t* r = rs + (N - 1 - S.t);  // rs holds the sequence reversed: c and its window run on together
  const int top = S.ext_c < S.t ? S.ext_c : S.t;
  const uint32_t zero = bm_prep<KIND>(F, T, 0u);
  uint32_t acc = 0;
  for (int j = id; j <= top; j += U * stride) {
    uint32_t cv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = j + u * stride;
      const bool in = k <= top;
      cv[u] = in ? c[k] : 0u;
      rv[u] = in ? r[k] : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc = A::add(F, acc, bm_mulp<KIND>(F, T, bm_prep<KIND>(F, T, cv[u]), rv[u]));
  }
  uint32_t d = bm_warp_sum<KIND>(F, acc);
  if constexpr (WIDE) {
    const int lane = id & 31;
    uint32_t* p = part + 32 * par;
    if (lane == 0) p[id >> 5] = d;
    __syncthreads();
    d = bm_warp_sum<KIND>(F, lane < (stride >> 5) ? p[lane] : 0u);
    par ^= 1;
  }
  return d;
}

// Step S.t given its d: c - coef x^m b, into the spare when L grows (the old c becomes b), in place
// otherwise; each thread writes only its own elements. b, read at other threads' elements, changes
// only by the rotation of the offsets, and the spare is written at least one step after it was last
// read as b, past the barrier of the dot that precedes (WIDE) or the __syncwarp that ends each update.
template <int KIND, bool WIDE>
__device__ __forceinline__ void bm_advance(const Field& F, const BmTables& T, BmState& S, uint32_t* __restrict__ buf,
                                           int N, int id, int stride, uint32_t d) {
  using A = Arith<KIND>;
  constexpr int U = BM_CHUNK;
  const int t = S.t++;
  if (d == 0) {
    ++S.m;
    return;
  }
  const uint32_t* c = buf + S.c;
  const uint32_t* b = buf + S.b;
  const int m = S.m;
  const bool grow = 2 * S.L <= t;
  int next = S.ext_c > m + S.ext_b ? S.ext_c : m + S.ext_b;
  if (next > N) next = N;  // capacity K = N + 1
  const int hi = grow ? next : (m + S.ext_b < N ? m + S.ext_b : N);
  uint32_t* dst = buf + (grow ? S.s : S.c);
  const uint32_t pc = bm_prep<KIND>(F, T, A::mul(F, d, S.inv_b));
  const int j0 = grow ? 0 : m;
  for (int j = j0 + ((id - j0) & (stride - 1)); j <= hi; j += U * stride) {
    uint32_t cv[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = j + u * stride;
      const bool in = k <= hi;
      cv[u] = in ? c[k] : 0u;
      bv[u] = in && k >= m ? b[k - m] : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = j + u * stride;
      const uint32_t v = A::sub(F, cv[u], bm_mulp<KIND>(F, T, pc, bm_prep<KIND>(F, T, bv[u])));
      if (k <= hi) dst[k] = v;
    }
  }
  if constexpr (!WIDE) __syncwarp();
  if (grow) {
    const int old_b = S.b;
    S.b = S.c;
    S.c = S.s;
    S.s = old_b;
    S.ext_b = S.ext_c;
    S.inv_b = A::inv(F, d);
    S.L = t + 1 - S.L;
    S.m = 1;
  } else {
    ++S.m;
  }
  S.ext_c = next;
}

// The field sum of n words, one lane's row of the batch's transpose
template <int KIND>
__device__ __forceinline__ uint32_t bm_row_sum(const Field& F, const uint32_t* row, int n) {
  if constexpr (KIND == field_scan::PRIME) {  // lazily in 64 bits (n <= 32 terms below 2^32), one Barrett step
    uint64_t x = 0;
    for (int l = 0; l < n; ++l) x += row[l];
    const uint64_t r = x - __umul64hi(x, F.mu) * F.p;
    return static_cast<uint32_t>(r >= F.p ? r - F.p : r);
  } else {
    uint32_t x = 0;
    for (int l = 0; l < n; ++l) x = Arith<KIND>::add(F, x, row[l]);
    return x;
  }
}

// While d = 0, c does not change: warp 0 takes the dots of the same c at steps S.t .. S.t + nb - 1
// at once (nb <= BM_S), each lane summing its elements' products into one partial a step, then a
// transpose through shared memory (tr, BM_S rows of 33) so that lane k sums step S.t + k's 32
// partials. Returns lane k's d (k < nb): the d the step-by-step scan takes there, until the first
// nonzero one, where c changes.
template <int KIND>
__device__ __forceinline__ uint32_t bm_batch(const Field& F, const BmTables& T, const BmState& S,
                                             const uint32_t* __restrict__ buf, const uint32_t* __restrict__ rs,
                                             int N, int lane, int nb, uint32_t* tr) {
  using A = Arith<KIND>;
  const uint32_t* c = buf + S.c;
  const uint32_t zero = bm_prep<KIND>(F, T, 0u);
  uint32_t acc[BM_S];
#pragma unroll
  for (int k = 0; k < BM_S; ++k) acc[k] = 0;
  const int top = S.ext_c < S.t + nb - 1 ? S.ext_c : S.t + nb - 1;
  for (int j = lane; j <= top; j += 32) {
    const uint32_t cj = bm_prep<KIND>(F, T, c[j]);
    const uint32_t* r = rs + (N - 1 - S.t + j);  // step S.t + k reads r[-k], where j <= S.t + k
#pragma unroll
    for (int k = 0; k < BM_S; ++k) {
      const bool in = k < nb && j <= S.t + k;
      acc[k] = A::add(F, acc[k], bm_mulp<KIND>(F, T, cj, in ? r[-k] : zero));
    }
  }
#pragma unroll
  for (int k = 0; k < BM_S; ++k) tr[k * 33 + lane] = acc[k];
  __syncwarp();
  const uint32_t d = bm_row_sum<KIND>(F, tr + lane * 33, 32);
  __syncwarp();
  return d;
}

// K13 over every kind but GF(2): the scan of seq (N) in one CTA of a power of two of warps. The
// sequence is staged once, reversed (the table kinds' in LOG form), with c, b and the spare, in
// shared memory (SMEM) or in the wrapper's global scratch; the table kinds' EXP and LOG go to shared
// memory for q <= BM_TAB_Q (TSMEM). Warp 0 runs the steps alone while c spans at most 32 BM_NARROW
// elements, after a step with d = 0 BM_S dots at a time; then every warp does, one barrier a step.
template <int KIND, typename T, bool SMEM, bool TSMEM>
__global__ void __launch_bounds__(BM_THREADS, 1) bm_long_kernel(const T* __restrict__ seq, int N, T* __restrict__ c_out,
                                                             long long* __restrict__ L_out,
                                                             uint32_t* __restrict__ scratch, Field F) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t part[64], tr[BM_S * 33];
  __shared__ BmState handoff;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int K = N + 1;  // capacity: elements of c, b and the spare
  BmTables Tb{F.exp, F.log};
  int tab = 0;
  if constexpr (TSMEM) {
    int* e = reinterpret_cast<int*>(smem);
    const int ne = static_cast<int>(4 * F.q1 + 1);
    for (int i = tid; i < ne; i += nt) e[i] = __ldg(F.exp + i);
    for (int i = tid; i <= static_cast<int>(F.q1); i += nt) e[ne + i] = __ldg(F.log + i);
    Tb = BmTables{e, e + ne};
    tab = ne + static_cast<int>(F.q1) + 1;
    __syncthreads();
  }
  uint32_t* buf = SMEM ? smem + tab : scratch;  // c, b, the spare, then the sequence
  uint32_t* rs = buf + 3 * K;
  for (int i = tid; i < 3 * K; i += nt) buf[i] = (i == 0 || i == K) ? 1u : 0u;
  for (int i = tid; i < N; i += nt) rs[i] = bm_prep<KIND>(F, Tb, static_cast<uint32_t>(seq[N - 1 - i]));
  __syncthreads();
  BmState S{0, K, 2 * K, 0, 0, 1, 0, 0, 1u};
  int par = 0;
  if (warp == 0) {
    bool run = false;  // the last step's d was 0
    while (S.t < N && S.ext_c < 32 * BM_NARROW) {
      uint32_t d;
      if (run) {
        const int nb = N - S.t < BM_S ? N - S.t : BM_S;
        const uint32_t dk = bm_batch<KIND>(F, Tb, S, buf, rs, N, lane, nb, tr);
        const uint32_t nz = __ballot_sync(0xffffffffu, lane < nb && dk != 0);
        if (!nz) {
          S.t += nb;
          S.m += nb;
          continue;
        }
        const int f = __ffs(nz) - 1;  // the first step whose d is not 0
        S.t += f;
        S.m += f;
        d = __shfl_sync(0xffffffffu, dk, f);
      } else {
        d = bm_dot<KIND, false>(F, Tb, S, buf, rs, N, lane, 32, part, par);
      }
      run = d == 0;
      bm_advance<KIND, false>(F, Tb, S, buf, N, lane, 32, d);
    }
    if (lane == 0) handoff = S;
  }
  __syncthreads();
  S = handoff;
  while (S.t < N) {
    const uint32_t d = bm_dot<KIND, true>(F, Tb, S, buf, rs, N, tid, nt, part, par);
    bm_advance<KIND, true>(F, Tb, S, buf, N, tid, nt, d);
  }
  __syncthreads();
  const uint32_t* c = buf + S.c;
  for (int j = tid; j <= N; j += nt) c_out[j] = static_cast<T>(c[j]);
  if (tid == 0) *L_out = S.L;
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

// K13 over GF(2), BM_S steps a block (the lookahead). With B = x^m b, a step is a 2 x 2 matrix over
// GF(2)[x] of degree at most 1 acting on (c, B): d = 0 gives (c, x B); d = 1 gives (c + B, x B), or
// (c + B, x c) when L grows. So the d of step t0 + k is sum_i u_i Dc(t0 + k - i) + v_i DB(t0 + k - i),
// where (u, v) is the first row of the product of the block's first k matrices and Dc(tau), DB(tau)
// are the dots of the block's starting c and B against the sequence at tau: every d, and so every
// decision, equals the step-by-step scan's. One block runs in three parts, one barrier in all:
//   1. the CTA computes the 2 BM_S dots as two words (bit k: tau = t0 + k), each thread XOR-ing
//      c AND the window shifted to each k into 32 words over its own words of c and b, a popc
//      parity each, then warp XORs and one barrier for the warps' partials;
//   2. every thread runs the BM_S scalar steps from those two words alone: d is the parity of
//      (u AND the reversed Dc window) XOR (v AND the reversed DB window), and the matrix's rows
//      (u, v) and (w, z) (B = w c + z B0) are 32-bit polynomials;
//   3. the CTA applies the rows, as carry-less products of degree < 32 by each set bit, to c and to
//      x^m b: c' into a spare, and where L grew, b' (the c of the last growth) into the other.
// Four buffers (c, b, two spares) and the sequence, reversed as bits after one zero word, live in
// shared memory (SMEM) or the wrapper's global scratch; each thread owns the words w = tid mod the
// CTA's size of every buffer, and reads its neighbours' only in part 3, past the part-1 barrier of
// its block that follows their last writes.
__device__ __forceinline__ uint32_t bm2_clmul(uint32_t u, uint32_t lo, uint32_t hi) {
  uint32_t r = 0;  // bits [32, 64) of u (hi:lo), u of degree < 32
  for (uint32_t bits = u; bits; bits &= bits - 1) r ^= __funnelshift_l(lo, hi, __ffs(bits) - 1);
  return r;
}

__device__ __forceinline__ int bm2_deg(uint32_t u) { return 31 - __clz(u); }

// Part 1 for one polynomial P (words 0..top) at R-bit offset o (the dot at tau = t0 + k reads
// R[o - k + j] for P's bit j): this thread's 32 partial parities, bit k for tau = t0 + k
__device__ __forceinline__ uint32_t bm2_dots(const uint32_t* __restrict__ P, int top, const uint32_t* __restrict__ Rp,
                                             int rw, int o, int id, int nt) {
  uint32_t acc[BM_S];
#pragma unroll
  for (int k = 0; k < BM_S; ++k) acc[k] = 0;
  for (int w = id; w <= top; w += nt) {
    const int p0 = o + 32 * w + 1;  // Rp's bit of R's bit o - 31 + 32 w (Rp starts with a zero word)
    const int i0 = p0 >> 5, sh = p0 & 31;
    const uint32_t a = i0 < rw ? Rp[i0] : 0u, b = i0 + 1 < rw ? Rp[i0 + 1] : 0u, e = i0 + 2 < rw ? Rp[i0 + 2] : 0u;
    const uint32_t lo = __funnelshift_r(a, b, sh), hi = __funnelshift_r(b, e, sh), pw = P[w];
#pragma unroll
    for (int k = 0; k < BM_S; ++k) acc[k] ^= pw & __funnelshift_r(lo, hi, BM_S - 1 - k);
  }
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < BM_S; ++k) bits |= (static_cast<uint32_t>(__popc(acc[k])) & 1u) << k;
  return bits;
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(BM2_THREADS) bm_gf2_kernel(const T* __restrict__ seq, int N, T* __restrict__ c_out,
                                                             long long* __restrict__ L_out,
                                                             uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t part[2][2][32];  // [parity][c or b][warp]
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int cw = bm2_cw(N), rw = bm2_rw(N), last = N >> 5;
  const uint32_t last_mask = (N & 31) == 31 ? 0xffffffffu : (2u << (N & 31)) - 1u;
  uint32_t* buf = SMEM ? smem : scratch;
  uint32_t* Rp = buf + 4 * cw;
  for (int i = tid; i < 4 * cw; i += nt) buf[i] = (i == 0 || i == cw) ? 1u : 0u;
  for (int r0 = warp; r0 < rw; r0 += 4 * nwarps) {  // Rp word 1 + r: s[N - 1 - 32 r - k] in bit k
    uint32_t bit[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = N - 1 - 32 * (r0 + u * nwarps - 1) - lane;
      bit[u] = r0 + u * nwarps >= 1 && i >= 0 ? static_cast<uint32_t>(seq[i]) & 1u : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t w = __ballot_sync(0xffffffffu, bit[u]);
      if (lane == 0 && r0 + u * nwarps < rw) Rp[r0 + u * nwarps] = w;
    }
  }
  __syncthreads();
  int oc = 0, ob = cw, s1 = 2 * cw, s2 = 3 * cw;  // offsets of c, b and the spares
  int L = 0, m = 1, ext_c = 0, ext_b = 0, par = 0;
  for (int t0 = 0; t0 < N; t0 += BM_S) {
    const int S = N - t0 < BM_S ? N - t0 : BM_S;
    const uint32_t* c = buf + oc;
    const uint32_t* b = buf + ob;
    // 1. the block's dots of c and of x^m b
    uint32_t dc = __reduce_xor_sync(0xffffffffu, bm2_dots(c, ext_c >> 5, Rp, rw, N - 1 - t0, tid, nt));
    uint32_t db = __reduce_xor_sync(0xffffffffu, bm2_dots(b, ext_b >> 5, Rp, rw, N - 1 - t0 + m, tid, nt));
    if (lane == 0) {
      part[par][0][warp] = dc;
      part[par][1][warp] = db;
    }
    __syncthreads();
    dc = __reduce_xor_sync(0xffffffffu, lane < nwarps ? part[par][0][lane] : 0u);
    db = __reduce_xor_sync(0xffffffffu, lane < nwarps ? part[par][1][lane] : 0u);
    par ^= 1;
    // 2. the block's steps: (u, v) and (w, z) the rows of c and B in terms of the block's c and B
    const uint32_t rdc = __brev(dc), rdb = __brev(db);
    uint32_t u = 1, v = 0, w = 0, z = 1, ug = 0, vg = 0;
    int kg = -1;
    for (int k = 0; k < S; ++k) {
      const int sh = BM_S - 1 - k;
      if (__popc((u & (rdc >> sh)) ^ (v & (rdb >> sh))) & 1) {
        if (2 * L <= t0 + k) {  // L grows: b becomes this c, B = x c
          ug = u;
          vg = v;
          u ^= w;
          v ^= z;
          w = ug << 1;
          z = vg << 1;
          L = t0 + k + 1 - L;
          kg = k;
          continue;
        }
        u ^= w;
        v ^= z;
      }
      w <<= 1;
      z <<= 1;
    }
    // 3. c' = u c + v x^m b; where L grew, b' = ug c + vg x^m b
    const int q = m >> 5, r = m & 31;
    int nc = ext_c + bm2_deg(u);
    if (v && m + ext_b + bm2_deg(v) > nc) nc = m + ext_b + bm2_deg(v);
    if (nc > N) nc = N;
    int nb = ext_b;
    if (kg >= 0) {
      nb = ext_c + bm2_deg(ug);
      if (vg && m + ext_b + bm2_deg(vg) > nb) nb = m + ext_b + bm2_deg(vg);
      if (nb > N) nb = N;
    }
    const int top = (nc > nb ? nc : nb) >> 5;
    for (int j = tid; j <= top; j += nt) {
      const uint32_t c0 = c[j], c1 = j ? c[j - 1] : 0u;
      // x^m b: words j and j - 1, from b's words j - q, j - q - 1, j - q - 2
      const uint32_t b0 = j >= q ? b[j - q] : 0u, b1 = j > q ? b[j - q - 1] : 0u, b2 = j > q + 1 ? b[j - q - 2] : 0u;
      const uint32_t B0 = __funnelshift_l(b1, b0, r), B1 = __funnelshift_l(b2, b1, r);
      if (j <= nc >> 5) {
        const uint32_t x = bm2_clmul(u, c1, c0) ^ bm2_clmul(v, B1, B0);
        buf[s1 + j] = j == last ? x & last_mask : x;
      }
      if (kg >= 0 && j <= nb >> 5) {
        const uint32_t x = bm2_clmul(ug, c1, c0) ^ bm2_clmul(vg, B1, B0);
        buf[s2 + j] = j == last ? x & last_mask : x;
      }
    }
    if (kg >= 0) {
      const int t = oc;
      oc = s1;
      s1 = t;
      const int t2 = ob;
      ob = s2;
      s2 = t2;
      m = S - kg;
    } else {
      const int t = oc;
      oc = s1;
      s1 = t;
      m += S;
    }
    ext_c = nc;
    ext_b = nb;
  }
  __syncthreads();
  const uint32_t* c = buf + oc;
  for (int j = tid; j <= N; j += nt) c_out[j] = static_cast<T>((c[j >> 5] >> (j & 31)) & 1u);
  if (tid == 0) *L_out = L;
}

// K13's layout for N and the field: the dynamic shared-memory bytes, whether the buffers and the
// sequence fit in smem_limit bytes of it (BM_SMEM where smem_limit is negative or larger), and the
// words of global scratch they need where they do not
struct BmPlan {
  size_t bytes;
  bool smem;
  long long scratch_words;
};

BmPlan bm_plan(int kind, int N, uint32_t q1, long long smem_limit) {
  const long long words = kind == field_scan::GF2 ? 4LL * bm2_cw(N) + bm2_rw(N) : 4LL * N + 3;
  const long long tab = bm_tab_words(kind, q1);
  const long long cap = static_cast<long long>(BM_SMEM), limit = smem_limit < 0 || smem_limit > cap ? cap : smem_limit;
  const bool smem = (tab + words) * static_cast<long long>(sizeof(uint32_t)) <= limit;
  return {static_cast<size_t>(tab + (smem ? words : 0)) * sizeof(uint32_t), smem, smem ? 0 : words};
}

template <int KIND, typename T, bool SMEM, bool TSMEM>
cudaError_t launch_bm_form(const BmPlan& P, int threads, const void* seq, int N, void* c_out, long long* L_out,
                           uint32_t* scratch, const Field& F, cudaStream_t s) {
  auto kernel = bm_long_kernel<KIND, T, SMEM, TSMEM>;
  if (P.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<1, threads, P.bytes, s>>>(static_cast<const T*>(seq), N, static_cast<T*>(c_out), L_out, scratch, F);
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t launch_bm(const void* seq, int N, void* c_out, long long* L_out, uint32_t* scratch, const Field& F,
                      long long smem_limit, cudaStream_t s) {
  const BmPlan P = bm_plan(KIND, N, F.q1, smem_limit);
  if (!P.smem && !scratch) return cudaErrorInvalidValue;
  if constexpr (KIND == field_scan::GF2) {
    auto kernel = P.smem ? bm_gf2_kernel<T, true> : bm_gf2_kernel<T, false>;
    if (P.bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.bytes);
      if (e != cudaSuccess) return e;
    }
    kernel<<<1, BM2_THREADS, P.bytes, s>>>(static_cast<const T*>(seq), N, static_cast<T*>(c_out), L_out, scratch);
    return cudaGetLastError();
  } else {
    // warp 0 alone takes every step unless c can span 32 BM_NARROW elements; then about BM_WIDE_UNITS
    // elements a thread at the full capacity (a power of two of warps, 8 to 16)
    int threads = BM_STAGE_THREADS;
    while (N + 1 > 32 * BM_NARROW && threads < BM_THREADS && threads * BM_WIDE_UNITS < N + 1) threads *= 2;
#define BM_FORM(SM, TS) launch_bm_form<KIND, T, SM, TS>(P, threads, seq, N, c_out, L_out, scratch, F, s)
    if constexpr (bm_tables(KIND)) {
      if (bm_tab_words(KIND, F.q1)) return P.smem ? BM_FORM(true, true) : BM_FORM(false, true);
    }
    return P.smem ? BM_FORM(true, false) : BM_FORM(false, false);
#undef BM_FORM
  }
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

// K13: c_out (N + 1) and L_out (1) of the Berlekamp-Massey scan of seq (N); but over GF(2), warp 0
// alone runs the steps while c spans fewer than 32 BM_NARROW elements. The buffers and the sequence
// take at most smem_limit bytes of shared memory (negative: the kernel's own budget, BM_SMEM), else the
// global words bm_long_scratch_words names (scratch).
extern "C" int bm_long_launch(const void* seq, int N, void* c_out, long long* L_out, unsigned* scratch,
                              int byte_storage, int kind, Field F, long long smem_limit, void* stream) {
  if (N < 1 || N > BM_MAX_N || !valid_field(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
#define BM_CALL(KIND)                                                                      \
  (byte_storage ? launch_bm<KIND, uint8_t>(seq, N, c_out, L_out, scratch, F, smem_limit, s) \
                : launch_bm<KIND, long long>(seq, N, c_out, L_out, scratch, F, smem_limit, s))
  SCAN_KINDS(BM_CALL)
#undef BM_CALL
  return static_cast<int>(e);
}

extern "C" long long bm_long_scratch_words(int N, int kind, unsigned q1, long long smem_limit) {
  return N < 1 || N > BM_MAX_N ? 0 : bm_plan(kind, N, q1, smem_limit).scratch_words;
}
