// Binned-ELL SpMM for NVIDIA Hopper (sm_90a): the executor of every
// structural-value aggregation of the port, forward on a layout and
// backward on its transpose layout.
//
// Replaces: gala_tpu/ops/pallas/bell_spmm.py::bell_spmm_planned (kernel
// `_kernel`), which computes, for one degree-class segment,
//     out[v, :] = sum_{k < K} vals[v, k] * x[cols[v, k], :]
// in f32, with hub segments emitting one partial per virtual row that
// XLA then segment-sums.  Here one call covers a whole layout in two
// launches over its work units (ops/graph.py WorkUnits, built once on the
// host; unit_gather.cuh):
//   pass 1  one warp per unit of at most kUnitSlots = 128 slots.  A row of
//           at most 128 slots (every bin row) is one unit that writes its
//           node's row, diag*x included.  A longer row (a hub, a long ELL
//           or edge-list row) is cut into ceil(len / 128) units, each
//           writing one partial row of a scratch table; on a binned
//           layout a hub's units are exactly its virtual rows (big_vrow),
//           the TPU kernel's partials.
//   pass 2  one block per split row sums its partials in unit order, adds
//           diag*x and writes the node's row: gala_tpu's big_vrow
//           segment-sum and diagonal term.
// No atomics: every sum runs in a fixed order, so results are bitwise the
// same from call to call.  Units run longest first and none is longer
// than 128 slots, so no row is a serial tail at the end of the grid.
//
// What bounds it on the H100: bytes.  Each slot gathers one row of x
// (4*F bytes, 2*F at bf16) and reads 8 bytes of (col, val); there are 2 flops per
// gathered float and no tile of x is reused across slots, so tensor cores
// (wgmma) have no role: the product is a weighted gather.  At F = 128 the
// Arxiv stand-in's 2.2M slots gather ~1.1 GB per call, against 3.35 TB/s
// of HBM (and 50 MB of L2 that holds a (169k, 32) f32 table whole, but
// not the (169k, 128) one).  The design answers with: the unit's
// contiguous (col, val) pairs brought into shared memory by 4-byte
// cp.async copies; full 16-byte loads on neighbouring lanes, so one warp
// reads a row of x as whole 128-byte lines, with 32 / g slots in flight
// per step (unit_gather.cuh, which says why plain loads and not a ring of
// cp.async copies); scalar loads where F % 4 != 0 or x is not 16-byte
// aligned; 8 blocks of 8 warps resident per SM (32 registers); narrow
// rows' slot groups summed by a shuffle tree.
//
// Not done yet (later work, see ROADMAP): one warp per unit, so a unit of
// a short row (k < 8 at F = 128) leaves most of its warp idle, and each
// unit pays its own chain of dependent loads (descriptor, pairs, rows):
// the gathers are latency-bound, not yet bytes-bound; a bf16 lane keeps
// 4 columns (8-byte loads), not 8.
//
// bf16 activations (gala_tpu's dtype=jnp.bfloat16, Pallas bell_spmm.py's
// bf16 tables): x and out bf16, each gathered row half the bytes; the
// values, diag, the partials and every sum f32, the values and diag
// rounded to bf16 before the multiply (gala_tpu's vals.astype(x.dtype)),
// one rounding per output row.
//
// Padding slots point at the phantom source row with value 0, so padding
// rows of x must be finite; the kernel does not special-case them.
// Output rows that no unit writes (padding) are left as the caller
// allocated them (zeros).

#include "unit_gather.cuh"

namespace {

using namespace gala;

constexpr int kMergeThreads = 128;

// one warp's share of the dynamic shared memory
struct WarpSmem {
  UnitSmem r;
  float val[kUnitSlots];
};
constexpr size_t kBlockSmem = sizeof(WarpSmem) * kWarpsPerBlock;
static_assert(kBlockSmem <= kDefaultSmem, "pass 1 would need cudaFuncSetAttribute");

// Pass 1: one warp per unit.  x and out are T (float or bf16); the
// values, diag and the partials f32.  At bf16 each value and diag is
// rounded to bf16 before its product, as gala_tpu multiplies
// vals.astype(x.dtype); sums stay f32 and a row is rounded once, where it
// is stored.
template <int VEC, class T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
spmm_unit_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const int32_t* __restrict__ unit_start,
                 const int32_t* __restrict__ unit_len, const int32_t* __restrict__ unit_node,
                 const int32_t* __restrict__ unit_part, const float* __restrict__ diag,
                 T* __restrict__ out, float* __restrict__ part, int n_units, int f,
                 int log2_g) {
  extern __shared__ float4 smem[];
  const int w = threadIdx.x / kWarp;
  const int unit = blockIdx.x * kWarpsPerBlock + w;
  if (unit >= n_units) return;  // the same for every lane of the warp
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem)[w];
  const Lanes ln(log2_g, f, f, VEC);
  const int start = unit_start[unit];
  const int len = unit_len[unit];

  for (int t = ln.lane; t < len; t += kWarp) {
    cp_async4(&sm.r.col[t], cols + start + t);
    cp_async4(&sm.val[t], vals + start + t);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  gather_unit<VEC>(sm.r, len, x, f, ln, [](int) { return true; },
                   [&](int j, const float (&v)[VEC]) {
                     const float wj = round_to<T>(sm.val[j]);
#pragma unroll
                     for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
                   });

  // sum the slot groups: lanes that share (lane % g) hold one vector
  for (int off = kWarp / 2; off >= ln.g; off >>= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += __shfl_xor_sync(kFullMask, acc[i], off);
  }
  if (ln.sub != 0 || !ln.active) return;
  const int p = unit_part[unit];
  const size_t col = static_cast<size_t>(ln.vcol) * VEC;
  if (p >= 0) {
    store_vec<VEC>(part + static_cast<size_t>(p) * f + col, acc);
    return;
  }
  const int node = unit_node[unit];
  const size_t o = static_cast<size_t>(node) * f + col;
  if (diag != nullptr) {
    const float d = round_to<T>(__ldg(diag + node));
    float v[VEC];
    load_vec<VEC>(x + o, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(d, v[i], acc[i]);
  }
  store_vec<VEC>(out + o, acc);
}

// Pass 2: one block per split row; its partials summed in unit order.
template <int VEC, class T>
__global__ void __launch_bounds__(kMergeThreads)
spmm_merge_kernel(const T* __restrict__ x, const float* __restrict__ part,
                  const int32_t* __restrict__ split_node, const int32_t* __restrict__ split_first,
                  const int32_t* __restrict__ split_count, const float* __restrict__ diag,
                  T* __restrict__ out, int f) {
  const int r = blockIdx.x;
  const int node = split_node[r];
  const int first = split_first[r];
  const int count = split_count[r];
  const float d = diag != nullptr ? round_to<T>(__ldg(diag + node)) : 0.f;
  for (int c = threadIdx.x * VEC; c < f; c += kMergeThreads * VEC) {
    float acc[VEC], v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int u = 0; u < count; ++u) {
      load_vec<VEC>(part + static_cast<size_t>(first + u) * f + c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += v[i];
    }
    const size_t o = static_cast<size_t>(node) * f + c;
    if (diag != nullptr) {
      load_vec<VEC>(x + o, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(d, v[i], acc[i]);
    }
    store_vec<VEC>(out + o, acc);
  }
}

template <int VEC, class T>
int launch(const T* x, const int32_t* cols, const float* vals, const int32_t* unit_start,
           const int32_t* unit_len, const int32_t* unit_node, const int32_t* unit_part,
           const int32_t* split_node, const int32_t* split_first, const int32_t* split_count,
           const float* diag, T* out, float* part, int n_units, int n_split, int f,
           cudaStream_t st) {
  int log2_g;
  dim3 grid;
  reduce_grid(n_units, f, VEC, &log2_g, &grid);
  spmm_unit_kernel<VEC, T><<<grid, kWarp * kWarpsPerBlock, kBlockSmem, st>>>(
      x, cols, vals, unit_start, unit_len, unit_node, unit_part, diag, out, part, n_units, f,
      log2_g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 0) return err;
  spmm_merge_kernel<VEC, T><<<n_split, kMergeThreads, 0, st>>>(x, part, split_node, split_first,
                                                               split_count, diag, out, f);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int run(const void* x, const void* cols, const void* vals, const void* unit_start,
        const void* unit_len, const void* unit_node, const void* unit_part,
        const void* split_node, const void* split_first, const void* split_count,
        const void* diag, void* out, void* part, int n_units, int n_split, int f, int vec,
        void* stream) {
  if (n_units <= 0 || f <= 0) return 0;
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto go = [&](auto vec_tag) {
    return launch<decltype(vec_tag)::value, T>(
        static_cast<const T*>(x), i32(cols), f32(vals), i32(unit_start), i32(unit_len),
        i32(unit_node), i32(unit_part), i32(split_node), i32(split_first), i32(split_count),
        f32(diag), static_cast<T*>(out), static_cast<float*>(part), n_units, n_split, f,
        static_cast<cudaStream_t>(stream));
  };
  return vec == 4 ? go(std::integral_constant<int, 4>{}) : go(std::integral_constant<int, 1>{});
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; diag
// may be null, and part (n_partials, f) f32 scratch is read only when
// n_split > 0.  The unit and split tables are ops/graph.py WorkUnits'.
// `vec` is 4 (F % 4 == 0 and x and out aligned to 4 elements) or 1.
// Launches pass 1 and, when a row is split, pass 2 on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
// gala_bell_spmm_f32: x and out f32; gala_bell_spmm_bf16: x and out bf16.
// vals and diag are f32 in both.
#define GALA_BELL_SPMM(NAME, T)                                                               \
  extern "C" int NAME(const void* x, const void* cols, const void* vals,                       \
                      const void* unit_start, const void* unit_len, const void* unit_node,     \
                      const void* unit_part, const void* split_node, const void* split_first,  \
                      const void* split_count, const void* diag, void* out, void* part,        \
                      int n_units, int n_split, int f, int vec, void* stream) {                \
    return run<T>(x, cols, vals, unit_start, unit_len, unit_node, unit_part, split_node,       \
                  split_first, split_count, diag, out, part, n_units, n_split, f, vec, stream); \
  }
GALA_BELL_SPMM(gala_bell_spmm_f32, float)
GALA_BELL_SPMM(gala_bell_spmm_bf16, bf16)

// Launch limits of the library's kernels, four ints each in `out`:
// registers per thread, static and dynamic shared memory per block,
// resident blocks per SM.  Kernel k: 0 pass 1 (float4), 1 pass 1
// (scalar), 2 pass 2 (float4), 3 pass 2 (scalar); 4-7 the same at bf16.
// Returns the CUDA error, 0 on success.
extern "C" int gala_bell_spmm_limits(int k, int* out) {
  const int block = kWarp * kWarpsPerBlock;
  switch (k) {
    case 0: return launch_limits(spmm_unit_kernel<4, float>, block, kBlockSmem, out);
    case 1: return launch_limits(spmm_unit_kernel<1, float>, block, kBlockSmem, out);
    case 2: return launch_limits(spmm_merge_kernel<4, float>, kMergeThreads, 0, out);
    case 3: return launch_limits(spmm_merge_kernel<1, float>, kMergeThreads, 0, out);
    case 4: return launch_limits(spmm_unit_kernel<4, bf16>, block, kBlockSmem, out);
    case 5: return launch_limits(spmm_unit_kernel<1, bf16>, block, kBlockSmem, out);
    case 6: return launch_limits(spmm_merge_kernel<4, bf16>, kMergeThreads, 0, out);
    case 7: return launch_limits(spmm_merge_kernel<1, bf16>, kMergeThreads, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
