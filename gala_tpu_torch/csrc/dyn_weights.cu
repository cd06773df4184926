// Per-slot weights of dynamic neighbor sampling for NVIDIA Hopper
// (sm_90a): for every slot s of an aggregation layout,
//
//   w[s] = (deg[s] > 0 ? #{i < k : (ra*i + rb) mod deg[s] == pos[s]} : 0) * vals[s]
//
// (vals[s] read as 1 when no values are given).  Summing the k picks
// (ra*i + rb) mod d of a row of degree d with repetition is the row's
// ordinary aggregation with these weights on its slots, so the sampled
// SpMM is the bell SpMM kernel run with w as its slot values.
//
// Replaces no Pallas kernel: gala_tpu computes these weights with XLA
// (gala_tpu/ops/spmm.py::_dyn_counts and _dyn_reweight, a fori_loop of
// k elementwise steps).  In eager PyTorch that loop would cost about 3k
// launches per sampled SpMM call; this kernel is one.
//
// What bounds it on the H100: bytes.  It reads deg, pos and vals (12
// bytes a slot) and writes w (4 bytes a slot): ~38 MB at the ~2.4M slots
// of the Arxiv stand-in's layouts, ~0.011 ms at 3.35 TB/s.  The count is
// k steps of integer adds and compares per slot, ~0.001 ms at k = 20.
//
// Design: one thread per slot, neighbouring threads on neighbouring
// slots (coalesced 4-byte loads and stores).  (ra*i + rb) mod d is
// stepped by adding ra mod d and subtracting d on overflow, so the loop
// holds no division; slots at a position past their row's degree (the
// padding of a binned row) and rows of degree 0 skip it.  Every result is
// a small integer times one f32 value: one rounding, the plain version's.
//
// Not done yet (later work): fusing the weights into the SpMM's own slot
// loads, which would drop the 16 bytes a slot written and read again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dyn_weights_kernel(const int32_t* __restrict__ deg, const int32_t* __restrict__ pos,
                   const float* __restrict__ vals, float* __restrict__ out, long long n,
                   int k, int ra, int rb) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int d = __ldg(deg + s);
  float w = 0.0f;
  if (d > 0) {
    const int p = __ldg(pos + s);
    int count = 0;
    if (p >= 0 && p < d) {
      const unsigned du = static_cast<unsigned>(d);
      const unsigned step = static_cast<unsigned>(ra) % du;
      unsigned r = static_cast<unsigned>(rb) % du;
      for (int i = 0; i < k; ++i) {
        count += r == static_cast<unsigned>(p);
        r += step;
        if (r >= du) r -= du;
      }
    }
    w = static_cast<float>(count);
  }
  if (vals != nullptr) w *= __ldg(vals + s);
  out[s] = w;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers: deg,
// pos (n,) int32, vals (n,) f32 or null, out (n,) f32.  k >= 0, ra >= 0,
// rb >= 0.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int gala_dyn_weights(const void* deg, const void* pos, const void* vals, void* out,
                                long long n, int k, int ra, int rb, void* stream) {
  if (n <= 0) return 0;
  if (k < 0 || ra < 0 || rb < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dyn_weights_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(pos),
      static_cast<const float*>(vals), static_cast<float*>(out), n, k, ra, rb);
  return static_cast<int>(cudaGetLastError());
}
