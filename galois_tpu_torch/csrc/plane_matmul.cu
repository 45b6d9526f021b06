// Kernels K1 and K2: the NTT's two fused balanced-plane prime matmuls, for Hopper.
//
// Replaces galois_tpu/ops/_pallas/_plane_matmul.py:
//   K1 plane_matmul_data_right (:323; pallas_call :361, body _kernel_data_right :219):
//        out = (A @ X) mod p, optionally * twiddle mod p   (NTT side 1)
//   K2 plane_matmul_data_left  (:261; pallas_call :292, body _kernel_data_left :179):
//        out = (X @ B) mod p, optionally written transposed (NTT side 2)
// and, inside them, the digit split _extract_planes (:152) and the diagonal
// fold _fold_diagonals (:164). A and B are static DFT tables, X is int64
// residue data in [0, p), p < 2^32; the batch is blockIdx.y.
//
// The function: with the n balanced base-256 int8 digits ("planes") of each
// operand, D_s = sum_{i+j=s} L_i @ R_j (2n - 1 int32 diagonal sums) and
// out = sum_s D_s * 2^(8s) mod p. That is n^2 int8 products per output
// element and K-step: n^2 * M*K*N multiply-accumulates per batch entry.
//
// What bounds it on the H100: int8 tensor-core operations. At the NTT's
// 4096^3 sides (n = 4, batch 4) it is 2^40 * 16 * 2 operations = 4.445 ms at
// 1979 TOP/s against about 0.4 ms of HBM bytes. Only wgmma reaches that rate
// on Hopper, so the design is a wgmma GEMM:
//
// - Digits once. A prologue kernel (plane_digits) turns the int64 data into
//   its n planes in the K-major layout that s8 wgmma needs (s8 has no
//   transpose bit): (B, n, rows, Kp) int8, each row's K digits contiguous and
//   zero padded to Kp, K rounded up to 16 (TMA's 16-byte strides; zero digits
//   add nothing). K1's data (B, K, N) goes through a shared-memory tile
//   transpose; K2's (B, M, K) is already K-major. The static tables come
//   K-major from the caller (MatmulFFTPlan.load_tables).
// - A TMA ring. Per block one producer thread issues two 4-D
//   cp.async.bulk.tensor loads per 64-deep K stage, all n planes of the
//   128-row left tile and of the BN-row right tile, into a ring of 4-6 stages
//   guarded by full/empty mbarriers. TMA's zero fill covers ragged M, N and
//   K, so the main loop has no masks. The tiles land with the 64-byte
//   swizzle, which the wgmma descriptors name (layout type 2, 512-byte
//   8-row groups).
// - Two consumer warpgroups (64 rows each) issue wgmma.mma_async
//   m64nBNk32.s32.s8.s8: per k32 step every plane pair (i, j) into
//   accumulator D_{i+j}. A comes from registers: each plane's fragment is
//   loaded once per step by ldmatrix.x4 (through the swizzle) and serves n
//   wgmmas, so shared memory supplies A once and B per wgmma (with A from
//   shared memory too, every wgmma re-reads its 2 KB of A, which asks some
//   150 bytes per clock of the 128 an SM has). The 2n - 1 accumulators live
//   in registers: (2n - 1) * BN / 2 per thread, so BN is 64, 48, 32 for
//   n = 3, 4, 5 (160, 168, 144 registers), and setmaxnreg gives the
//   consumers 232 registers and the producer 40. One wgmma group stays in
//   flight while the next step's fragments load.
//   Per block and stage: n (128 + BN) * 64 bytes from L2 for n^2 * 128 * BN
//   * 64 MACs, about 140 MACs per byte at n = 4.
// - Blocks walk the output tiles in groups of 8 tile rows, so the blocks in
//   flight share their left and right tiles in L2.
// - The epilogue folds sum_s D_s 2^(8s) mod p, stages the 64 x BN int64
//   tile of each warpgroup in shared memory (the ring, free by then) and
//   writes it out coalesced: rows of BN for K1 (times the
//   twiddle, prefetched into L2 at the start, read coalesced), columns of
//   64 for K2's transposed store. The fold and the twiddle product run in
//   float64, where every value stays an exact integer below 2^53: Horner
//   over pairs of diagonals with a reduction t - round(t / p) p by fused
//   multiply-adds per step (4 steps at n = 4). They replaced 64-bit Barrett
//   reductions, whose chains of dependent integer multiplies two warps per
//   scheduler could not hide.
//
// Exactness: each D_s sums at most n plane-pair products of K terms of
// magnitude <= 128^2, so the caller's gate n * K * 128^2 < min(2^31, p)
// keeps D_s exact in int32 (the s8 wgmma accumulates without saturation) and
// |D_s| < p.
//
// Every entry point returns a CUDA error code, cudaGetLastError() after its
// launch; the tensor maps come from libcuda's cuTensorMapEncodeTiled,
// reached through the runtime (no -lcuda).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                 // output rows per block: two consumer warpgroups of 64
constexpr int BK = 64;                  // contraction bytes per stage: one 64-byte swizzle row
constexpr int THREADS = 3 * 128;        // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block can have on the H100
constexpr int GROUP_M = 8;              // tile rows per raster group

template <int NP> struct TileN;
template <> struct TileN<3> { static constexpr int value = 64; };
template <> struct TileN<4> { static constexpr int value = 48; };
template <> struct TileN<5> { static constexpr int value = 32; };

template <int NP>
struct Config {
  static constexpr int BN = TileN<NP>::value;
  static constexpr int A_BYTES = NP * BM * BK;   // n planes of the 128-row left tile
  static constexpr int B_BYTES = NP * BN * BK;   // n planes of the BN-row right tile
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 2048) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
  static constexpr int EPI_STRIDE = BN + 1;                 // int64 words per staged output row
  static_assert(STAGE_BYTES % 1024 == 0 && (BN * BK) % 512 == 0, "tiles must keep the swizzle phase");
  static_assert(BM * EPI_STRIDE * 8 <= STAGES * STAGE_BYTES, "the output tile must fit in the ring");
  static_assert(STAGES >= 3, "too few stages");
};

// ---------------------------------------------------------------- digits

// The n balanced base-256 digits of the symmetric residue of v in [0, p),
// as int8 bytes of the result, lowest digit in the lowest byte: with
// bias = 0x80...80 (n bytes) they are the bytes of (x' + bias) ^ bias.
// Up to four planes fit 32-bit arithmetic (exact modulo 2^32).
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

// (B, R, K) int64 rows -> (B, NP, R, Kp) int8 planes. One thread per 16
// digits of a row: 16 loads, NP 16-byte stores; digits at k >= K are 0.
template <int NP>
__global__ void __launch_bounds__(256) digits_rows_kernel(const long long* __restrict__ x, int8_t* __restrict__ out,
                                                          int R, int K, int Kp, long long p) {
  const int chunks = Kp / 16;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(R) * chunks) return;
  const long long b = blockIdx.y;
  const int r = static_cast<int>(idx / chunks), c = static_cast<int>(idx % chunks);
  const long long* row = x + (b * R + r) * K;
  unsigned words[NP][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned long long d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * c + 4 * q + e;
      d[e] = balanced_digits<NP>(k < K ? __ldg(row + k) : 0, p);
    }
    unsigned w[NP];
    pack_planes<NP>(d, w);
#pragma unroll
    for (int i = 0; i < NP; ++i) words[i][q] = w[i];
  }
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<uint4*>(out + ((b * NP + i) * R + r) * Kp + 16 * c) =
        make_uint4(words[i][0], words[i][1], words[i][2], words[i][3]);
}

// (B, K, R) int64, R contiguous -> (B, NP, R, Kp) int8 planes, through a
// 64 x 64 shared-memory tile: loads coalesced along R, 16-byte stores along K.
template <int NP>
__global__ void __launch_bounds__(256) digits_cols_kernel(const long long* __restrict__ x, int8_t* __restrict__ out,
                                                          int K, int R, int Kp, long long p) {
  __shared__ unsigned tile[NP][64][17];  // 16 words of k per row, padded: no bank conflicts
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const long long b = blockIdx.z;
  const long long* xb = x + b * K * R;
  const int rl = t % 64, kg = t / 64;  // a thread's row and its 16 k
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned long long d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 16 * kg + 4 * q + e, r = r0 + rl;
      d[e] = balanced_digits<NP>(k < K && r < R ? __ldg(xb + static_cast<long long>(k) * R + r) : 0, p);
    }
    unsigned w[NP];
    pack_planes<NP>(d, w);
#pragma unroll
    for (int i = 0; i < NP; ++i) tile[i][rl][4 * kg + q] = w[i];
  }
  __syncthreads();
  const int row = t / 4, q = t % 4;
  const int r = r0 + row, k = k0 + 16 * q;
  if (r >= R || k >= Kp) return;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const unsigned* w = tile[i][row] + 4 * q;
    *reinterpret_cast<uint4*>(out + ((b * NP + i) * R + r) * Kp + k) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 64-byte
// swizzle: rows of 64 bytes, 8-row groups 512 bytes apart (SBO), the
// leading offset unused (1), layout type 2 (64B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ULL << 16) | (32ULL << 32) | (2ULL << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries (it emits no instruction).
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x BN, s32) += A (64 x 32, s8) @ B (32 x BN, s8): A from registers (the
// warp's 16 rows, four words as ldmatrix.x4 gives them), B K-major in shared memory.
template <int BN> struct Wgmma;

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(int (&d)[16], const unsigned (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<48> {
  static __device__ __forceinline__ void run(int (&d)[24], const unsigned (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], const unsigned (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The four 8 x 16-byte matrices of an A fragment from shared memory.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Modular arithmetic in float64, where every value stays an exact integer
// below 2^53 (float64 has full-rate fused multiply-adds; 64-bit integer
// products and Barrett reductions do not).

// int32 or uint32 -> float64 through the exponent bits (2^52 + 2^31 + x, or
// 2^52 + x, has the exponent word 0x43300000): a full-rate add instead of the
// conversion unit.
__device__ __forceinline__ double exact_double(int x) {
  return __hiloint2double(0x43300000, static_cast<int>(static_cast<unsigned>(x) ^ 0x80000000u)) - 4503601774854144.0;
}
__device__ __forceinline__ double exact_double(unsigned x) {
  return __hiloint2double(0x43300000, static_cast<int>(x)) - 4503599627370496.0;
}

// t - q p for |t| < 2^51 with q = t / p rounded by the 1.5 * 2^52 shifter:
// |result| < 1.5 p (q may miss the nearest integer by one).
__device__ __forceinline__ double reduce(double t, double pd, double pinv) {
  constexpr double shifter = 6755399441055744.0;
  return fma(-(fma(t, pinv, shifter) - shifter), pd, t);
}

// A reduced t as the residue in [0, p).
__device__ __forceinline__ long long canonical(double t, long long p) {
  long long v = static_cast<long long>(t);
  if (v < 0) v += p;
  if (v < 0) v += p;
  if (v >= p) v -= p;
  return v;
}

// (a * b) mod p for a, b < p < 2^32: b = bh 2^16 + bl, so a bh < 2^48 and,
// after a reduction, t 2^16 + a bl < 2^50.
__device__ __forceinline__ long long mulmod(unsigned a, unsigned b, long long p, double pd, double pinv) {
  const double da = exact_double(a);
  const double t = reduce(da * exact_double(b >> 16), pd, pinv);
  return canonical(reduce(fma(t, 65536.0, da * exact_double(b & 0xFFFFu)), pd, pinv), p);
}

// ---------------------------------------------------------------- the GEMM

// out[b] = (L[b] @ R[b]^T) mod p over the planes: L (.., NP, M, Kp) and
// R (.., NP, N, Kp) int8, K-major, through map_l and map_r (a table is one
// batch entry, read by every b). out is (B, M, N) int64, or (B, N, M) when
// transpose_out; times twiddle (M, N) mod p when twiddle != nullptr.
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
plane_matmul_kernel(const __grid_constant__ CUtensorMap map_l, const __grid_constant__ CUtensorMap map_r,
                    const long long* __restrict__ twiddle, long long* __restrict__ out, int M, int N, int Kp,
                    int tiles_m, int tiles_n, int l_batched, int r_batched, long long p, int transpose_out) {
  using C = Config<NP>;
  constexpr int BN = C::BN;
  constexpr int ND = 2 * NP - 1;  // diagonal accumulators
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[C::STAGES], empty[C::STAGES];
  // the ring starts on a 1 KB boundary of shared memory, so every tile keeps the swizzle's phase
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  // grouped raster: GROUP_M tile rows at a time, walked column by column
  const int tile = blockIdx.x, group = GROUP_M * tiles_n;
  const int first_m = (tile / group) * GROUP_M;
  const int rows = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (tile % group) % rows) * BM;
  const int n0 = ((tile % group) / rows) * BN;
  const int b = blockIdx.y;
  const int num_k = (Kp + BK - 1) / BK;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive with the expected bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const int bl = l_batched ? b : 0, br = r_batched ? b : 0;
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(&empty[s], ((kt / C::STAGES) - 1) & 1);
        uint8_t* st = smem + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(st, &map_l, &full[s], kt * BK, m0, 0, bl);
        tma_load_4d(st + C::A_BYTES, &map_r, &full[s], kt * BK, n0, 0, br);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid % 32, warp = (tid % 128) / 32;
    int acc[ND][BN / 2];
#pragma unroll
    for (int s = 0; s < ND; ++s)
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[s][r] = 0;

    if (twiddle != nullptr) {
      // the epilogue reads this tile's twiddles: fetch their 128-byte lines into L2 now
      constexpr int LINES = BN / 16;
      for (int i = tid; i < BM * LINES; i += 256) {
        const int m = m0 + i / LINES, n = n0 + 16 * (i % LINES);
        if (m < M && n < N)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(twiddle + static_cast<long long>(m) * N + n));
      }
    }
    // ldmatrix.x4 rows: lanes 0-7 and 16-23 give rows 0-7 of the warp's 16, lanes 8-15 and
    // 24-31 rows 8-15; lanes 16-31 the second 16 bytes of the k32 step. Rows are 64 bytes,
    // their 16-byte chunks swizzled by (row / 2) % 4.
    const int lrow = warp * 16 + (lane & 15), lhalf = lane >> 4, lswz = (lrow >> 1) & 3;
    const uint32_t ring = smem_u32(smem);
    for (int kt = 0; kt < num_k; ++kt) {
      const int s = kt % C::STAGES;
      mbar_wait(&full[s], (kt / C::STAGES) & 1);
      const uint32_t a_base = ring + s * C::STAGE_BYTES + wg * 64 * BK + lrow * BK;  // this lane's A row
      const uint32_t b_base = ring + s * C::STAGE_BYTES + C::A_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        // the group that last read this kk's A registers, one stage back, is done; at the
        // last kk that is all of the previous stage: release its buffers
        wgmma_wait<1>();
        if (kk == BK / 32 - 1 && kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % C::STAGES]);
        unsigned af[NP][4];  // each plane's A fragment serves NP wgmmas
#pragma unroll
        for (int i = 0; i < NP; ++i) ldmatrix_x4(af[i], a_base + i * BM * BK + (((2 * kk + lhalf) ^ lswz) << 4));
#pragma unroll
        for (int d = 0; d < ND; ++d) fence_regs(acc[d]);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < NP; ++i)
#pragma unroll
          for (int j = 0; j < NP; ++j) Wgmma<BN>::run(acc[i + j], af[i], smem_desc(b_base + j * BN * BK + kk * 32));
        wgmma_commit();
#pragma unroll
        for (int d = 0; d < ND; ++d) fence_regs(acc[d]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < ND; ++d) fence_regs(acc[d]);

    // fold, stage the tile in the ring (both warpgroups are done with it), write out coalesced
    named_bar_sync(1, 256);
    const double pd = static_cast<double>(p), pinv = 1.0 / pd;
    unsigned long long* stage = reinterpret_cast<unsigned long long*>(smem) + wg * 64 * C::EPI_STRIDE;
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) {
      // wgmma's accumulator layout: register r of lane l in warp w
      const int row = warp * 16 + lane / 4 + ((r & 2) ? 8 : 0);
      const int col = (r / 4) * 8 + 2 * (lane % 4) + (r & 1);
      // sum_s D_s 2^(8s) mod p by Horner over pairs of diagonals: g = D_2k + 256 D_2k+1
      // (|g| < 2^40), t = t 2^16 + g (|t| < 2^50), reduced after each step
      double t = 0.0;
#pragma unroll
      for (int k = (ND - 1) / 2; k >= 0; --k) {
        const double hi = 2 * k + 1 < ND ? exact_double(acc[2 * k + 1 < ND ? 2 * k + 1 : 0][r]) : 0.0;
        t = reduce(fma(t, 65536.0, fma(hi, 256.0, exact_double(acc[2 * k][r]))), pd, pinv);
      }
      stage[row * C::EPI_STRIDE + col] = static_cast<unsigned long long>(canonical(t, p));
    }
    // each thread's outputs: rows of BN (K1) or columns of 64 (K2's transposed store)
    const int t = tid % 128, mw = m0 + wg * 64;
    const long long bb = b;
    auto place = [&](int it, int& m, int& n, int& at) {
      const int idx = t + 128 * it;
      const int row = transpose_out ? idx % 64 : idx / BN, col = transpose_out ? idx / 64 : idx % BN;
      m = mw + row;
      n = n0 + col;
      at = row * C::EPI_STRIDE + col;
    };
    unsigned long long tw[BN / 2];  // all of a thread's twiddle loads in flight at once
    if (twiddle != nullptr) {
#pragma unroll
      for (int it = 0; it < BN / 2; ++it) {
        int m, n, at;
        place(it, m, n, at);
        tw[it] = m < M && n < N ? static_cast<unsigned long long>(twiddle[static_cast<long long>(m) * N + n]) : 0;
      }
    }
    named_bar_sync(2 + wg, 128);
#pragma unroll
    for (int it = 0; it < BN / 2; ++it) {
      int m, n, at;
      place(it, m, n, at);
      if (m >= M || n >= N) continue;
      unsigned long long v = stage[at];
      if (twiddle != nullptr) v = mulmod(static_cast<unsigned>(v), static_cast<unsigned>(tw[it]), p, pd, pinv);
      out[transpose_out ? (bb * N + n) * M + m : (bb * M + m) * N + n] = static_cast<long long>(v);
    }
  }
}

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (batch, NP, rows, Kp) int8 operand, loaded as boxes of 64 k x box_rows x NP planes.
bool make_map(CUtensorMap* map, const void* base, int batch, int np, int rows, int Kp, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(np), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(Kp) * rows,
                                 static_cast<cuuint64_t>(Kp) * rows * np};
  const cuuint32_t box[4] = {BK, static_cast<cuuint32_t>(box_rows), static_cast<cuuint32_t>(np), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
int launch_gemm(const int8_t* lhs, int lhs_batched, const int8_t* rhs, int rhs_batched, const long long* twiddle,
                long long* out, int batch, int M, int N, int Kp, long long p, int transpose_out, cudaStream_t s) {
  using C = Config<NP>;
  CUtensorMap map_l, map_r;
  if (!make_map(&map_l, lhs, lhs_batched ? batch : 1, NP, M, Kp, BM) ||
      !make_map(&map_r, rhs, rhs_batched ? batch : 1, NP, N, Kp, C::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(plane_matmul_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + C::BN - 1) / C::BN;
  const dim3 grid(tiles_m * tiles_n, batch);
  plane_matmul_kernel<NP><<<grid, THREADS, C::SMEM, s>>>(map_l, map_r, twiddle, out, M, N, Kp, tiles_m, tiles_n,
                                                         lhs_batched, rhs_batched, p, transpose_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_digits(const long long* x, int8_t* out, int batch, int rows, int K, int Kp, long long p, int cols,
                  cudaStream_t s) {
  if (cols) {
    const dim3 grid((rows + 63) / 64, (Kp + 63) / 64, batch);
    digits_cols_kernel<NP><<<grid, 256, 0, s>>>(x, out, K, rows, Kp, p);
  } else {
    const long long threads = static_cast<long long>(rows) * (Kp / 16);
    const dim3 grid(static_cast<unsigned>((threads + 255) / 256), batch);
    digits_rows_kernel<NP><<<grid, 256, 0, s>>>(x, out, rows, K, Kp, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The data operand's planes: x (batch, rows, K) int64 (cols = 0) or
// (batch, K, rows) (cols = 1) -> out (batch, n, rows, Kp) int8, zero digits
// at k >= K.
int plane_digits(const long long* x, int8_t* out, int batch, int rows, int K, int Kp, int n_planes, long long p,
                 int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kp % 16 != 0 || Kp < K) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_planes) {
    case 3: return launch_digits<3>(x, out, batch, rows, K, Kp, p, cols, s);
    case 4: return launch_digits<4>(x, out, batch, rows, K, Kp, p, cols, s);
    case 5: return launch_digits<5>(x, out, batch, rows, K, Kp, p, cols, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1 and K2: out[b] = (L[b] @ R[b]^T) mod p for K-major planes L
// ((batch or 1), n, M, Kp) and R ((batch or 1), n, N, Kp); out (batch, M, N)
// int64, or (batch, N, M) when transpose_out; times twiddle (M, N) when not
// NULL. K1 passes its table as L and the data's planes as R, K2 the data's
// planes as L and its table as R.
int plane_matmul(const int8_t* lhs, int lhs_batched, const int8_t* rhs, int rhs_batched, const long long* twiddle,
                 long long* out, int batch, int M, int N, int Kp, int n_planes, long long p, int transpose_out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kp % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_planes) {
    case 3: return launch_gemm<3>(lhs, lhs_batched, rhs, rhs_batched, twiddle, out, batch, M, N, Kp, p, transpose_out, s);
    case 4: return launch_gemm<4>(lhs, lhs_batched, rhs, rhs_batched, twiddle, out, batch, M, N, Kp, p, transpose_out, s);
    case 5: return launch_gemm<5>(lhs, lhs_batched, rhs, rhs_batched, twiddle, out, batch, M, N, Kp, p, transpose_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
