// Per-edge dot products (SDDMM) for NVIDIA Hopper (sm_90a): the gradient
// of learned edge values in every spmm_ev backward of the port.
//
// Replaces: gala_tpu/ops/pallas/sddmm.py::sddmm_planned (kernel `_kernel`),
// which computes dvals[e] = <a[dst[e]], b[src[e]]> over chunks of edges
// whose rows it stages in VMEM by block DMA and resolves with one-hot MXU
// matmuls.  None of that carries over.  This kernel names its operands
// in the order of the caller, gala_tpu.ops.spmm.sddmm_edges(src, dst, a, b):
//     out[e] = sum_f a[src[e], f] * b[dst[e], f]          (f32)
// over the edge list in forward (dst-sorted) order.
//
// What bounds it on the H100: bytes.  Each edge gathers one row of a at
// a random source (4*F bytes), one row of b at its destination, 8 bytes
// of indices, and writes 4 bytes; 2*F flops.  On the Arxiv stand-in
// (2.1M edges, F = 32 and 40) the a-rows are ~2.1M x (128, 160) B per
// call against 3.35 TB/s of HBM, and the (169k, F) tables fit in the
// 50 MB L2.  Consecutive edges share their destination (the list is
// dst-sorted), so b's rows are served from L1.
//
// Design: the work is split by EDGES, not by destination rows, so a
// hub's thousands of edges spread over many warps: no serial tail (the
// measured bottleneck of the row-per-warp bell and attention kernels).
// A group of g lanes (the power of two >= F/VEC, at most 32) takes one
// edge: each lane strides over the row in VEC-float vectors (float4
// where F % 4 == 0 and both tables are 16-byte aligned, so a group reads
// whole 16-byte pieces of a row; scalar for ragged F), then the group
// sums its lanes with a shuffle tree.  Every edge is one group's, summed
// in a fixed order: deterministic, no atomics.
//
// Not done yet (later work, see ROADMAP): no shared-memory staging or
// cp.async; f32 only; lanes idle when F/VEC is not a power of two
// (F = 40: 10 of 16).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ float dot_vec(const float* __restrict__ pa,
                                         const float* __restrict__ pb) {
  if constexpr (VEC == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(pa));
    const float4 v = __ldg(reinterpret_cast<const float4*>(pb));
    return fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, u.x * v.x)));
  } else {
    return __ldg(pa) * __ldg(pb);
  }
}

// Group (thread >> log2_g) of the grid takes edge e; the groups of one
// warp are consecutive edges.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             float* __restrict__ out, int n_edges, int f, int log2_g) {
  const int g = 1 << log2_g;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long warp_first = (tid & ~static_cast<long long>(kWarp - 1)) >> log2_g;
  if (warp_first >= n_edges) return;  // the same for every lane of the warp

  const long long e = tid >> log2_g;
  const int sub = threadIdx.x & (g - 1);
  const bool valid = e < n_edges;
  float acc = 0.f;
  if (valid) {
    const float* pa = a + static_cast<size_t>(__ldg(src + e)) * f;
    const float* pb = b + static_cast<size_t>(__ldg(dst + e)) * f;
    const int fv = f / VEC;
    for (int j = sub; j < fv; j += g) acc += dot_vec<VEC>(pa + j * VEC, pb + j * VEC);
  }
  // sum the group's lanes: xor partners below g stay inside the group
  for (int off = g >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  if (valid && sub == 0) out[e] = acc;
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; a is
// (rows_a, f), b (rows_b, f), both row-major; src and dst (n_edges,)
// int32 with every src < rows_a and dst < rows_b; out (n_edges,).
// `vec` is 4 (f % 4 == 0 and 16-byte aligned a and b) or 1.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success).
extern "C" int gala_sddmm_f32(const void* a, const void* b, const void* src, const void* dst,
                              void* out, int n_edges, int f, int vec, void* stream) {
  if (n_edges <= 0 || f <= 0) return 0;
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int fv = f / vec;
  int log2_g = 0;
  while ((1 << log2_g) < fv && log2_g < 5) ++log2_g;
  const long long edges_per_block = kThreads >> log2_g;
  const long long blocks = (static_cast<long long>(n_edges) + edges_per_block - 1) / edges_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const int32_t* s = static_cast<const int32_t*>(src);
  const int32_t* d = static_cast<const int32_t*>(dst);
  float* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec == 4) {
    sddmm_kernel<4><<<grid, kThreads, 0, st>>>(af, bf, s, d, o, n_edges, f, log2_g);
  } else {
    sddmm_kernel<1><<<grid, kThreads, 0, st>>>(af, bf, s, d, o, n_edges, f, log2_g);
  }
  return static_cast<int>(cudaGetLastError());
}
