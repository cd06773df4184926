// Binned-ELL SpMM for NVIDIA Hopper (sm_90a): the executor of every
// structural-value aggregation of the port, forward on a layout and
// backward on its transpose layout.
//
// Replaces: gala_tpu/ops/pallas/bell_spmm.py::bell_spmm_planned (kernel
// `_kernel`), which computes, for one degree-class segment,
//     out[v, :] = sum_{k < K} vals[v, k] * x[cols[v, k], :]
// in f32, with hub segments emitting one partial per virtual row that
// XLA then segment-sums.  Here ONE launch covers the whole layout: every
// output row (bin rows and hub rows alike) is described on the host by
// (row_start, row_len, row_node) over the flat slot arrays.  A hub's
// virtual rows are contiguous slots, so a hub is one long row and the
// segment-sum, the out_index reorder and the diag*x term all fold into
// the row loop: no atomics, and the result is deterministic.
//
// What bounds it on the H100: bytes.  Each slot gathers one row of x
// (4*F bytes) and reads 8 bytes of (col, val); there are 2 flops per
// gathered float.  At F = 128 the Arxiv stand-in's 2.2M slots gather
// ~1.1 GB per call, against 3.35 TB/s of HBM (and 50 MB of L2 that
// holds a (169k, 32) f32 table whole, but not the (169k, 128) one).
// The design answers with full 16-byte loads (float4, where F % 4 == 0)
// on neighbouring lanes, so one warp reads a row of x as whole 128-byte
// lines; with one coalesced load of 32 (col, val) pairs per warp,
// broadcast by shuffles, so no lane waits on its own index load before
// each gather; and, for narrow F, with several slots in flight per warp
// (32 / lanes-per-row) summed by a shuffle tree at the end.
//
// Not done yet (later work, see ROADMAP): hub rows are one warp each, so
// the longest row (6,656 slots on the Arxiv stand-in) is a serial tail;
// no shared-memory staging, cp.async or TMA; f32 only.
//
// Padding slots point at the phantom source row with value 0, so padding
// rows of x must be finite; the kernel does not special-case them.
// Output rows that no descriptor names (padding) are left as the caller
// allocated them (zeros).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// One warp per output row.  Lanes split as (slot group, feature lane):
// g = 2^log2_g lanes across the row's F/VEC vectors, 32/g slots in
// flight; blockIdx.y selects which g-vector slice of the row this warp
// computes (F/VEC > 32 needs several).
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
bell_spmm_kernel(const float* __restrict__ x, const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const int32_t* __restrict__ row_start,
                 const int32_t* __restrict__ row_len, const int32_t* __restrict__ row_node,
                 const float* __restrict__ diag, float* __restrict__ out, int n_rows,
                 int f, int log2_g) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // the same for every lane of the warp

  const int g = 1 << log2_g;
  const int s = kWarp >> log2_g;
  const int sub = lane >> log2_g;
  const int vcol = blockIdx.y * g + (lane & (g - 1));
  const bool active = vcol < f / VEC;
  const int start = row_start[row];
  const int len = row_len[row];

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int base = 0; base < len; base += kWarp) {
    const int t = base + lane;
    int c = 0;
    float w = 0.f;
    if (t < len) {
      c = __ldg(cols + start + t);
      w = __ldg(vals + start + t);
    }
    const int n = min(kWarp, len - base);  // the same for every lane
#pragma unroll 4
    for (int j = 0; j < n; j += s) {
      const int src = j + sub;  // < 32: j is a multiple of s below 32
      const int cj = __shfl_sync(kFullMask, c, src);
      const float wj = __shfl_sync(kFullMask, w, src);
      if (src < n && active) {
        float v[VEC];
        load_vec<VEC>(x + static_cast<size_t>(cj) * f + static_cast<size_t>(vcol) * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
      }
    }
  }

  // sum the s slot groups: lanes that share (lane % g) hold one vector
  for (int off = kWarp / 2; off >= g; off >>= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(kFullMask, acc[i], off);
  }

  if (sub == 0 && active) {
    const int node = row_node[row];
    const size_t o = static_cast<size_t>(node) * f + static_cast<size_t>(vcol) * VEC;
    if (diag != nullptr) {
      const float d = __ldg(diag + node);
      float v[VEC];
      load_vec<VEC>(x + o, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(d, v[i], acc[i]);
    }
    store_vec<VEC>(out + o, acc);
  }
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; diag
// may be null.  `vec` is 4 (F % 4 == 0 and 16-byte aligned x and out)
// or 1.  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int gala_bell_spmm_f32(const void* x, const void* cols, const void* vals,
                                  const void* row_start, const void* row_len,
                                  const void* row_node, const void* diag, void* out,
                                  int n_rows, int f, int vec, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int fv = f / vec;
  int log2_g = 0;
  while ((1 << log2_g) < fv && log2_g < 5) ++log2_g;
  const int g = 1 << log2_g;
  const dim3 block(kWarp * kWarpsPerBlock);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock, (fv + g - 1) / g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* w = static_cast<const float*>(vals);
  const int32_t* rs = static_cast<const int32_t*>(row_start);
  const int32_t* rl = static_cast<const int32_t*>(row_len);
  const int32_t* rn = static_cast<const int32_t*>(row_node);
  const float* d = static_cast<const float*>(diag);
  float* o = static_cast<float*>(out);
  if (vec == 4) {
    bell_spmm_kernel<4><<<grid, block, 0, st>>>(xf, c, w, rs, rl, rn, d, o, n_rows, f, log2_g);
  } else {
    bell_spmm_kernel<1><<<grid, block, 0, st>>>(xf, c, w, rs, rl, rn, d, o, n_rows, f, log2_g);
  }
  return static_cast<int>(cudaGetLastError());
}
