// What the unit-based kernels of bell_spmm.cu and attn_bell.cu share: the
// work-unit size, the asynchronous copies, the lane roles of a warp that
// reduces rows of x, and the warp's gather of one unit's rows of x.
//
// Element types: the tables a kernel gathers are float or __nv_bfloat16
// (bf16 activations, gala_tpu's dtype=jnp.bfloat16).  A lane keeps its
// VEC = 4 columns either way: one 16-byte load at f32, one 8-byte load at
// bf16, widened to f32 in registers (exact).  All arithmetic is f32; a
// bf16 store rounds to nearest even (__float2bfloat16_rn, XLA's rounding).
//
// A work unit (ops/graph.py WorkUnits) is at most kUnitSlots contiguous
// slots of one row; one warp computes one unit.  Its gather is plain
// loads, float4 where the row allows, with 32 / g slots in flight per step
// of the warp (g lanes across a row's vectors).
//
// Plain loads were measured against a per-warp ring of 16-byte
// cp.async.ca copies in shared memory (H100 80GB HBM3 at 700 W, Arxiv
// stand-in; scripts/ring_vs_plain_torch.py, PERF.md): the results were
// bitwise the same and plain loads were the faster in every case (the
// SpMM by 1-4%, the attention forward by 10-15%, bwd2 by 5-10%), so the
// ring was taken out.  The gathers are latency-bound: occupancy (warps
// per SM) and L1 count for more than explicit staging.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace gala {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnitSlots = 128;  // L: ops/graph.py UNIT_SLOTS (= data.ell.K_BIG)
constexpr unsigned kFullMask = 0xffffffffu;
// resident blocks per SM that the unit kernels ask of the compiler (their
// __launch_bounds__): 8 blocks of 8 warps, so at most 32 registers
constexpr int kMinBlocks = 8;

// the unit's columns: the head of each warp's share of the dynamic shared
// memory (a multiple of 16 bytes, so what follows stays 16-byte aligned)
struct UnitSmem {
  int32_t col[kUnitSlots];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

using bf16 = __nv_bfloat16;

// bf16 bits -> f32: the bf16 value is the high half of its f32 (exact)
__device__ __forceinline__ float bf16_bits(uint32_t hi) { return __uint_as_float(hi << 16); }

// one element of a table, as f32
__device__ __forceinline__ float ld(const float* __restrict__ p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* __restrict__ p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// v as a T would hold it: the identity at f32, bf16's rounding at bf16
template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, bf16>) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

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

// VEC = 4: one 8-byte load (p 8-byte aligned); element 0 is the low half
template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_bits(t.x);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = bf16_bits(t.y);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else {
    v[0] = ld(p);
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

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// rounds each value once; VEC = 4: one 8-byte store (p 8-byte aligned)
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// Lane roles of a warp that reduces rows of x: g = 2^log2_g lanes across
// the row's width/VEC vectors, 32/g slot groups; `slice` (blockIdx.y
// unless given) selects which g-vector slice of the row this warp reduces.
// hd is the head of the lane's vector for heads of fh columns (VEC divides
// fh, so a vector never straddles two heads; fh = width gives hd = 0).
struct Lanes {
  int lane, sub, groups, g, vcol, hd;
  bool active;
  __device__ Lanes(int log2_g, int width, int fh, int vec)
      : Lanes(log2_g, width, fh, vec, static_cast<int>(blockIdx.y)) {}
  __device__ Lanes(int log2_g, int width, int fh, int vec, int slice) {
    lane = threadIdx.x & (kWarp - 1);
    g = 1 << log2_g;
    groups = kWarp >> log2_g;
    sub = lane >> log2_g;
    vcol = slice * g + (lane & (g - 1));
    active = vcol < width / vec;
    hd = active ? (vcol * vec) / fh : 0;
  }
};

// The warp's gather of one unit: for each slot j < len of this lane's slot
// group for which want(j) holds, use(j, v) with v the lane's VEC values
// (as f32) of row col[j] of x (row stride f elements of T, float or bf16).
// col is the unit's columns in shared memory, filled before the call and
// visible to the whole warp.  A slot that want() refuses is not read.
template <int VEC, class T, class Want, class Use>
__device__ __forceinline__ void gather_unit(const UnitSmem& sm, int len, const T* __restrict__ x,
                                            int f, const Lanes& ln, Want want, Use use) {
  if (!ln.active) return;
  const T* xv = x + static_cast<size_t>(ln.vcol) * VEC;
#pragma unroll 4
  for (int j = ln.sub; j < len; j += ln.groups) {
    if (want(j)) {
      float v[VEC];
      load_vec<VEC>(xv + static_cast<size_t>(sm.col[j]) * f, v);
      use(j, v);
    }
  }
}

// log2 of the lanes across a row's vectors (a power of two, at most 32)
// and the grid that covers n_items warps' work and the row's vectors g at
// a time
inline void reduce_grid(int n_items, int width, int vec, int* log2_g, dim3* grid) {
  const int fv = width / vec;
  int l = 0;
  while ((1 << l) < fv && l < 5) ++l;
  const int g = 1 << l;
  *log2_g = l;
  *grid = dim3((n_items + kWarpsPerBlock - 1) / kWarpsPerBlock, (fv + g - 1) / g);
}

// A kernel's launch limits: registers per thread, static and dynamic
// shared memory per block, resident blocks per SM at `block` threads and
// `dyn_smem` bytes (out[0..3]).  Returns the CUDA error, 0 on success.
template <class Kernel>
int launch_limits(Kernel kernel, int block, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(dyn_smem);
  out[3] = blocks;
  return 0;
}

// The most dynamic shared memory a block may take without
// cudaFuncSetAttribute: the unit kernels stay under it (static_assert in
// each source), so no launch needs the attribute.
constexpr size_t kDefaultSmem = 48 * 1024;

}  // namespace gala
