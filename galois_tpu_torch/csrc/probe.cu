// Kernel K11: the device probe.
//
// Replaces galois_tpu/ops/_pallas/_elementwise.py:73 pallas_probe (pl.pallas_call
// :81), which adds 1 to an (8, 1024) u32 block to show that the toolchain
// reaches the device. Here: out = x + 1 over n int32 elements, one thread
// per element. chip_smoke.py launches it right after the build and before
// any other kernel, so a broken toolchain or CUDA runtime shows apart from a
// kernel that fails. Its 32 KB are nothing to the card: its time is launch
// latency.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void probe_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) out[i] = x[i] + 1;
}

}  // namespace

extern "C" int probe_launch(const int32_t* x, int32_t* out, long long n, void* stream) {
  if (n <= 0 || n > (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  probe_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
