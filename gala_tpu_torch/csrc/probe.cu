// Toolchain probe for NVIDIA Hopper (sm_90a): out = 2 * x on n floats (a
// 128 x 128 f32 tile in the probe).  It computes nothing that the port
// needs; building, loading and launching it answers whether nvcc, the
// CUDA runtime and the card work together (ops/kernels/_build.py
// toolchain_available).
//
// Replaces: gala_tpu/ops/pallas/__init__.py::mosaic_available, whose
// probe runs the same x*2 kernel through Pallas/Mosaic in a subprocess.
// Bound: bytes (each float read once and written once); at the tile, the
// launch.  A grid of ceil(n / 1024) blocks of 256 threads, each thread
// one float4 (16-byte loads and stores where both pointers are 16-byte
// aligned; the ragged end and unaligned pointers take scalar ones), so
// every SM takes part and no thread walks the array.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // one float4

__global__ void __launch_bounds__(kThreads) probe_kernel(const float* __restrict__ x,
                                                         float* __restrict__ out, long long n,
                                                         bool vec) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (vec && i + kPerThread <= n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
    *reinterpret_cast<float4*>(out + i) = make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
    return;
  }
  for (long long j = i; j < i + kPerThread && j < n; ++j) out[j] = 2.f * __ldg(x + j);
}

}  // namespace

// C interface, loaded with ctypes: x and out are device pointers of n
// floats.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int gala_probe_f32(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long per_block = kThreads * kPerThread;
  const unsigned blocks = static_cast<unsigned>((n + per_block - 1) / per_block);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}
