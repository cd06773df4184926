// What the unit-based kernels of bell_spmm.cu and attn_bell.cu share: the
// work-unit size, the asynchronous copies, the lane roles of a warp that
// reduces rows of x, and the warp's gather of its units' rows of x.
//
// Element types: the tables a kernel gathers are float or __nv_bfloat16
// (bf16 activations, gala_tpu's dtype=jnp.bfloat16).  A lane keeps VEC
// columns: 4 at f32 (one 16-byte load); at bf16 8 (one 16-byte load) in
// the SpMM and the attention forward, 4 (one 8-byte load) in bwd1 and
// bwd2; widened to f32 in registers (exact).  All arithmetic is f32; a
// bf16 store rounds to nearest even (__float2bfloat16_rn, XLA's rounding).
//
// A work unit (ops/graph.py WorkUnits) is at most kUnitSlots contiguous
// slots of one row.  Every unit kernel runs several short units a warp
// (`WarpUnits`): three units in four hold at most 8 slots, and one warp a
// unit paid the unit's whole chain of dependent loads (descriptor,
// columns, rows, store) for a few rows.  A unit's level l is the largest
// l < kLevels with length <= kUnitSlots >> l; a warp takes G = min(2^l,
// 32 / g) consecutive units of one level (and one column tile), so its
// units hold at most kUnitSlots slots together and fit the one-unit shared
// memory.  The host cuts the warps once (ops/graph.py warp_tables: one
// table per g < 32; at g = 32 a warp takes one unit): the warp reads its
// first unit and count (one load), the units' descriptors (one coalesced
// load, lane i unit i), then its 32 / G lanes per unit copy that unit's
// columns and stage them, and each unit's 32 / (G g) slot groups sum its
// rows, reduced by a shuffle tree inside the unit's lanes.  Every row is
// summed in a fixed order: results are bitwise the same from call to
// call.
//
// Plain loads were measured against a per-warp ring of 16-byte
// cp.async.ca copies in shared memory (H100 80GB HBM3 at 700 W, Arxiv
// stand-in; PERF.md, PRs 6 and 15): the results were bitwise the same and
// plain loads were the faster in every case (the SpMM by 1-4%, the
// attention forward by 10-15%, bwd2 by 5-10%), so the ring was taken out.
// Bulk copies of whole rows (cp.async.bulk of a 512-byte row slice into a
// per-warp ring of 4, lane 0 issuing, each stage's completion on an
// mbarrier; scripts/unit_variants_torch.py, variant bulk) were about 3x
// slower than plain loads for the SpMM at F = 128 f32 (bitwise equal
// results; PERF.md has the times): a row waits for its barrier and one
// lane issues every copy.  The gathers are latency-bound: occupancy (warps
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
constexpr int kLog2UnitSlots = 7;
constexpr int kLevels = 6;        // ops/graph.py UNIT_LEVELS
constexpr int kPackedLanes = 5;   // ops/graph.py PACKED_LANES: log2_g below it reads a warp table
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
  if constexpr (VEC == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
    v[6] = b.z;
    v[7] = b.w;
  } else if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// VEC = 8: one 16-byte load (p 16-byte aligned); VEC = 4: one 8-byte load
// (p 8-byte aligned); element 0 is the low half
template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_bits(w[i]);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (VEC == 4) {
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
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// rounds each value once; VEC = 8: one 16-byte store (p 16-byte aligned);
// VEC = 4: one 8-byte store (p 8-byte aligned)
template <int VEC>
__device__ __forceinline__ void store_vec(bf16* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                              bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// A table entry loaded where it is used (a unit's first slot, int64: a
// layout may pass 2^31 slots; a unit's node): the load is volatile, so the
// compiler neither hoists it nor keeps its registers live from an earlier
// load (the unit kernels run at a 32-register cap).
__device__ __forceinline__ int64_t load_at_use(const int64_t* p) {
  int64_t v;
  asm volatile("ld.global.nc.s64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int32_t load_at_use(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// Several units a warp (the pass 1 of the SpMM and the three attention
// kernels).
// The warp's units are [first, first + count); G = the power of two at
// least count (count <= 32 / g, so G <= 32 / g); a unit has ul = 32 / G
// lanes (lanes [ui ul, (ui + 1) ul) take unit ui).  The units' slots sit
// back to back in the warp's shared memory (unit ui's from `off`, the sum
// of the lengths before it; at most kUnitSlots in all, as a unit holds at
// most kUnitSlots / G).  A unit's lanes hold its first slot and length (len
// = 0 on the lanes of a unit the warp lacks); its node and partial row are
// loaded where they are used (`node`, `part`).  The roles are recomputed
// from the lane where needed, so they hold no registers through the gather.
struct WarpUnits {
  int first, count, log2_ul, len, off;
  int64_t start;
  // the staging copy: the warp's slots, and whether its units lie back to
  // back in the layout from start0 (units of one bin do)
  int64_t start0;
  int total;
  bool contig;
  __device__ __forceinline__ int lane() const { return threadIdx.x & (kWarp - 1); }
  __device__ __forceinline__ int ui() const { return lane() >> log2_ul; }
  __device__ __forceinline__ int t0() const { return lane() & ((1 << log2_ul) - 1); }
  __device__ __forceinline__ bool valid() const { return ui() < count; }
  __device__ __forceinline__ int node(const int32_t* unit_node) const {
    return load_at_use(unit_node + first + ui());
  }
  __device__ __forceinline__ int part(const int32_t* unit_part) const {
    return load_at_use(unit_part + first + ui());
  }
};

// The units of warp `wi`; false when wi is past the last warp (the same
// for every lane of the warp).  warp_first is the warp table of this g
// (ops/graph.py WorkUnits.warps), null at g = 32: warp wi takes unit wi.
// Lane i < count loads unit first + i's first slot and length (one
// coalesced load each); a scan of the lengths over the lanes gives each
// unit's place in shared memory, and each lane takes its unit's by a
// shuffle.
__device__ __forceinline__ bool warp_units(const int32_t* __restrict__ warp_first, int wi,
                                           int n_warps, const int64_t* __restrict__ unit_start,
                                           const int32_t* __restrict__ unit_len,
                                           WarpUnits& wu) {
  if (wi >= n_warps) return false;
  const int lane = threadIdx.x & (kWarp - 1);
  int first = wi, count = 1;
  if (warp_first != nullptr) {
    const int v = lane < 2 ? __ldg(warp_first + wi + lane) : 0;
    first = __shfl_sync(kFullMask, v, 0);
    count = __shfl_sync(kFullMask, v, 1) - first;
  }
  wu.first = first;
  wu.count = count;
  wu.log2_ul = 5 - (count > 1 ? 32 - __clz(count - 1) : 0);
  int64_t start = 0;
  int len = 0;
  if (lane < count) {
    start = __ldg(unit_start + first + lane);
    len = __ldg(unit_len + first + lane);
  }
  int incl = len;  // lengths summed over lanes <= lane
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += v;
  }
  const int64_t next = __shfl_down_sync(kFullMask, start, 1);
  wu.contig = __all_sync(kFullMask, lane + 1 >= count || start + len == next);
  wu.total = __shfl_sync(kFullMask, incl, kWarp - 1);
  wu.start0 = __shfl_sync(kFullMask, start, 0);
  const int ui = lane >> wu.log2_ul;
  wu.off = __shfl_sync(kFullMask, incl - len, ui);
  wu.start = __shfl_sync(kFullMask, start, ui);
  len = __shfl_sync(kFullMask, len, ui);
  wu.len = ui < count ? len : 0;
  return true;
}

// The staging copy of the warp's slots: copy(i, slot) for each of them,
// i its place in shared memory.  Units back to back in the layout are
// copied by the whole warp, neighbouring lanes on neighbouring slots; else
// each unit's lanes copy its slots.
template <class Copy>
__device__ __forceinline__ void stage_units(const WarpUnits& wu, Copy copy) {
  if (wu.contig) {
    for (int t = wu.lane(); t < wu.total; t += kWarp) copy(t, wu.start0 + t);
  } else {
    for (int t = wu.t0(); t < wu.len; t += 1 << wu.log2_ul) copy(wu.off + t, wu.start + t);
  }
}

// The gather roles of a lane of a warp of units, under g = 2^log2_g lanes
// across a row (a row's vectors of VEC columns; slice `slice` of g of them):
// the unit's lanes are its ul / g slot groups (sg of `groups`).  hd is the
// head of the lane's vector for heads of fh columns (VEC divides fh; fh =
// width gives hd = 0).
struct RowLanes {
  int log2_g, sg, groups, vcol, hd;
  bool active;
  __device__ __forceinline__ RowLanes(const WarpUnits& wu, int log2_g_, int width, int fh,
                                      int vec, int slice) {
    log2_g = log2_g_;
    sg = wu.t0() >> log2_g;
    groups = 1 << (wu.log2_ul - log2_g);
    vcol = (slice << log2_g) + (wu.lane() & ((1 << log2_g) - 1));
    active = vcol < width / vec;
    hd = active ? (vcol * vec) / fh : 0;
  }
};

// The warp's gather of its units: for each slot j < len of this lane's
// unit and slot group for which want(j) holds, use(j, v) with v the lane's
// VEC values (as f32) of row col[j] of x (row stride f elements; col is
// the unit's columns in shared memory).  U slots of a group in flight per
// step.  The lane reads its row's columns from vcol * VEC - back on
// (back = 0: its own; attn_bwd2_kernel's shared dout block the same
// columns for every head).
template <int VEC, int U, class T, class Want, class Use>
__device__ __forceinline__ void gather_units(const int32_t* col, const WarpUnits& wu,
                                             const RowLanes& rl, const T* __restrict__ x, int f,
                                             Want want, Use use, int back = 0) {
  if (!rl.active) return;
  const T* xv = x + static_cast<size_t>(rl.vcol) * VEC - back;
  const int step = rl.groups * U;
  for (int j0 = rl.sg; j0 < wu.len; j0 += step) {
    float v[U][VEC];
    bool on[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int j = j0 + k * rl.groups;
      on[k] = j < wu.len && want(j);
      if (on[k]) load_vec<VEC>(xv + static_cast<size_t>(col[j]) * f, v[k]);
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (on[k]) use(j0 + k * rl.groups, v[k]);
  }
}

// v reduced by op over the unit's lanes that share their lane index below
// `stop` (a power of two; 1: the whole unit), a butterfly from the widest
// stride down (every lane of the warp calls it)
template <class Op>
__device__ __forceinline__ float reduce_lanes(float v, const WarpUnits& wu, int stop, Op op) {
  for (int off = (1 << wu.log2_ul) >> 1; off >= stop; off >>= 1)
    v = op(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// max and sum of v over the unit's lanes, or over those that share their
// index below stop
__device__ __forceinline__ float unit_max(float v, const WarpUnits& wu, int stop = 1) {
  return reduce_lanes(v, wu, stop, [](float a, float b) { return fmaxf(a, b); });
}
__device__ __forceinline__ float unit_sum(float v, const WarpUnits& wu, int stop = 1) {
  return reduce_lanes(v, wu, stop, [](float a, float b) { return a + b; });
}

// the sum of v over the unit's slot groups (every lane of the warp calls it)
__device__ __forceinline__ float sum_groups(float v, const WarpUnits& wu, const RowLanes& rl) {
  return unit_sum(v, wu, 1 << rl.log2_g);
}

// log2 of the lanes across a row's vectors (a power of two, at most 32),
// as ops/graph.py row_lanes
inline int row_lanes(int vectors) {
  int l = 0;
  while ((1 << l) < vectors && l < 5) ++l;
  return l;
}

// log2 of the lanes across a row's vectors and the grid that covers
// n_items warps' work and the row's vectors g at a time
inline void reduce_grid(int n_items, int width, int vec, int* log2_g, dim3* grid) {
  const int fv = width / vec;
  const int l = row_lanes(fv);
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
