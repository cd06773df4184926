// Toolchain probe for NVIDIA Hopper (sm_90a): out = 2 * x on one 128 x 128
// f32 tile.  It computes nothing that the port needs; building, loading
// and launching it answers whether nvcc, the CUDA runtime and the card
// work together (ops/kernels/_build.py toolchain_available).
//
// Replaces: gala_tpu/ops/pallas/__init__.py::mosaic_available, whose
// probe runs the same x*2 kernel through Pallas/Mosaic in a subprocess.
// Bound: 128 KB moved, nothing to speak of; one block of 256 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) probe_kernel(const float* __restrict__ x,
                                                         float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) out[i] = 2.f * x[i];
}

}  // namespace

// C interface, loaded with ctypes: x and out are device pointers of n
// floats.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int gala_probe_f32(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
