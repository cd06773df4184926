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
//   pass 1  several short units a warp.  A row of at most 128 slots
//           (every bin row) is one unit that writes its node's row, diag*x
//           included.  A longer row (a hub, a long ELL or edge-list row)
//           is cut into ceil(len / 128) units, each writing one partial
//           row of a scratch table; on a binned layout a hub's units are
//           exactly its virtual rows (big_vrow), the TPU kernel's
//           partials.  A warp takes min(2^l, 32 / g) consecutive units of
//           level l (units of at most 128 >> l slots; WorkUnits' warp
//           tables), g lanes across the row: 32 units of <= 4 slots at F
//           = 1, 4 of <= 32 at F = 32 f32, one 128-slot hub unit at any F.
//   pass 2  one block per split row sums its partials in unit order, adds
//           diag*x and writes the node's row: gala_tpu's big_vrow
//           segment-sum and diagonal term.
// No atomics: every sum runs in a fixed order, so results are bitwise the
// same from call to call.  Units run longest first and none is longer
// than 128 slots, so no row is a serial tail at the end of the grid.
//
// What bounds it on the H100.  Each slot gathers one row of x (4*F bytes,
// 2*F at bf16) and reads 8 bytes of (col, val); there are 2 flops per
// gathered float and no tile of x is reused across slots, so tensor cores
// (wgmma) have no role: the product is a weighted gather.  At F = 128 f32
// the Arxiv stand-in's 2.2M slots gather ~1.1 GB a call from a (169k,
// 128) table that L2 (50 MB) does not hold: bytes from HBM (3.35 TB/s)
// bound it (0.24 ms, the gathered rows at ~4.7 TB/s of L2 and HBM
// together).  Narrower
// rows come from L2, and there the chain of dependent loads of each unit
// bounded it: three units in four hold at most 8 slots, and one warp a
// unit paid the unit's descriptor, columns, rows and store for a few rows
// with most lanes idle.  The design answers with: several units a warp,
// their descriptors in one coalesced load and a scan of their lengths;
// their (col, val) pairs staged in shared memory by 4-byte cp.async
// copies, by the whole warp in one coalesced sweep where the units lie
// back to back (units of one bin do); 16-byte loads on neighbouring lanes
// (4 f32 or 8 bf16 columns), so g lanes read a row slice as whole lines;
// 8 blocks of 8 warps resident per SM (32 registers, the rows in flight
// chosen to fit: 4 scalar, 2 of 16 bytes at f32, 1 of 16 bytes of 8 bf16
// columns); a unit's slot groups summed by a shuffle tree inside its
// lanes.  Measured (H100 80GB HBM3, 700 W, scripts/unit_kernels_torch.py,
// PERF.md): F = 32 f32 0.111 -> 0.074 ms, bf16 0.098 -> 0.052; F = 1's
// device time 0.049 -> 0.016 ms (a call of three launches is then bound by
// the host's ~20 us of launch calls); F = 128 f32 unchanged.  Bulk copies
// of whole rows (cp.async.bulk into a per-warp ring, completion on an
// mbarrier; scripts/unit_variants_torch.py, variant bulk) were about 3x
// slower than plain loads at F = 128, so plain loads stay.
//
// Dynamic neighbor sampling (the sampled form of pass 1, a template flag:
// the unsampled instantiations are the code they were).  The k picks
// (ra*i + rb) mod d of a row of degree d, summed with repetition, are the
// row's aggregation with slot weights
//     w[s] = (deg[s] > 0 ? #{i < k : (ra*i + rb) mod deg[s] == pos[s]} : 0) * v[s]
// (v the slot's structural value, 1 without values), so the sampled SpMM
// is this kernel with w as its slot values.  Replaces no Pallas kernel:
// gala_tpu computes the weights with XLA
// (gala_tpu/ops/spmm.py::_dyn_counts and _dyn_reweight, a fori_loop of k
// elementwise steps).  A kernel of its own wrote w (16 bytes a slot
// written and read again, ~38 MB a call at the ~2.4M slots of the Arxiv
// stand-in's layouts, ~0.011 ms at 3.35 TB/s, and a launch and an
// allocation a call); here pass 1 makes the weights where the unsampled
// form stages the values: each lane loads its row's degree and its
// unit's slots' positions beside the staging copies (12 bytes a slot
// where the unsampled form reads 8, and the degree once a unit), steps
// through the row's k picks once for all its slots (weigh_slots) and
// writes count * value over the staged value.  Each weight is a small
// integer times one f32 value, the same bits as the plain version's, and
// the sums run in the same order: the call equals the SpMM run with the
// plain weights as values, bit for bit.
//
// bf16 activations (gala_tpu's dtype=jnp.bfloat16, Pallas bell_spmm.py's
// bf16 tables): x and out bf16, each gathered row half the bytes; the
// values, diag, the partials and every sum f32, the values and diag
// rounded to bf16 before the multiply (gala_tpu's vals.astype(x.dtype)),
// one rounding per output row.
//
// Padding slots point at the phantom source row with value 0, so padding
// rows of x must be finite; the kernel does not special-case them.
// Output rows that no unit writes (padding) are 0: the call zeroes them
// first (cudaMemsetAsync on its stream), from the host's n_written on
// (WorkUnits: every row below it is some unit's node).  Zeroing all of
// out took ~0.026 of the ~0.23 device ms a call at F = 128 f32 (H100
// 80GB HBM3, 700 W, torch.profiler; PERF.md).

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

// The inputs of the sampled form: slot s lies at in-row position pos[s]
// of a row of deg[s] neighbors (ops/graph.py DynSlots); k picks.
struct Sampling {
  const int32_t* deg;
  const int32_t* pos;
  int k, ra, rb;
};

// resident blocks per SM the sampled form asks of the compiler: its
// staging needs more than the unsampled form's 32 registers (at 8 blocks
// it spilled 8-12 bytes; at 6, 40 registers, none; PERF.md)
constexpr int kSampledBlocks = 6;

// the slots of a unit a lane of it weighs: slots t0, t0 + ul, ... of a
// unit of at most kUnitSlots / G slots on ul = 32 / G lanes
constexpr int kLaneSlots = kUnitSlots / kWarp;

// The sampled form's weights, after the staging copied each slot's
// column and value (`val`, the warp's staged values) and each lane
// loaded its row's degree d and the in-row positions p[m] of its unit's
// slots t0 + m ul (-1 past the unit).  A unit's slots are slots of one
// row, so the lane steps through the row's k picks (ra*i + rb) mod d once
// for all of them: r starts at rb mod d and adds ra mod d, d subtracted
// on overflow (two divisions a lane, none in the loop), and each slot
// counts the picks at its position; then its value becomes count * value
// (the count alone without values).  A row of degree 0 takes no pick,
// and no pick lands past the degree (a binned row's padding).  Counting
// each slot's picks in a loop of its own took k steps a slot, as the
// weights kernel did, and cost as much device time (PERF.md).
__device__ __forceinline__ void weigh_slots(const WarpUnits& wu, int k, int ra, int rb, int d,
                                            const int (&p)[kLaneSlots], bool valued,
                                            float* val) {
  if (!wu.valid()) return;
  int c[kLaneSlots] = {};
  if (d > 0) {
    const unsigned du = static_cast<unsigned>(d);
    const unsigned step = static_cast<unsigned>(ra) % du;
    unsigned r = static_cast<unsigned>(rb) % du;
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int m = 0; m < kLaneSlots; ++m) c[m] += r == static_cast<unsigned>(p[m]);
      r += step;
      if (r >= du) r -= du;
    }
  }
#pragma unroll
  for (int m = 0; m < kLaneSlots; ++m) {
    const int t = wu.t0() + (m << wu.log2_ul);
    if (t < wu.len) {
      const int i = wu.off + t;
      val[i] = static_cast<float>(c[m]) * (valued ? val[i] : 1.f);
    }
  }
}

// rows of a slot group in flight per step of the gather, as many as keep
// pass 1 at 32 registers: 4 scalar loads, 2 of 16 bytes (f32) or 8 bytes
// (bf16), 1 of 16 bytes of 8 bf16 columns
template <int VEC>
constexpr int kRowsInFlight = VEC == 1 ? 4 : VEC == 4 ? 2 : 1;

// Pass 1: several short units a warp (unit_gather.cuh WarpUnits; one at g
// = 32).  x and out are T (float or bf16); the values, diag and the
// partials f32.  At bf16 each value and diag is rounded to bf16 before its
// product, as gala_tpu multiplies vals.astype(x.dtype); sums stay f32 and
// a row is rounded once, where it is stored.  SAMPLED: the values are the
// sampling weights of `smp` times `vals` (null: 1), made in the staging.
template <int VEC, class T, bool SAMPLED>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, SAMPLED ? kSampledBlocks : kMinBlocks)
spmm_unit_kernel(const T* __restrict__ x, const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const int64_t* __restrict__ unit_start,
                 const int32_t* __restrict__ unit_len, const int32_t* __restrict__ unit_node,
                 const int32_t* __restrict__ unit_part, const int32_t* __restrict__ warp_first,
                 const float* __restrict__ diag, T* __restrict__ out, float* __restrict__ part,
                 int n_warps, int f, int log2_g, Sampling smp) {
  extern __shared__ float4 smem[];
  const int w = threadIdx.x / kWarp;
  WarpUnits wu;
  if (!warp_units(warp_first, blockIdx.x * kWarpsPerBlock + w, n_warps, unit_start, unit_len,
                  wu))
    return;  // the same for every lane of the warp
  WarpSmem& sm = reinterpret_cast<WarpSmem*>(smem)[w];
  int row_deg = 0, row_pos[kLaneSlots];  // the sampled form: the lane's degree and positions
  stage_units(wu, [&](int i, int64_t slot) {
    cp_async4(&sm.r.col[i], cols + slot);
    if (!SAMPLED || vals != nullptr) cp_async4(&sm.val[i], vals + slot);
  });
  if constexpr (SAMPLED) {
    const bool mine = wu.valid() && wu.len > 0;
    if (mine) row_deg = __ldg(smp.deg + wu.start);
#pragma unroll
    for (int m = 0; m < kLaneSlots; ++m) {
      const int t = wu.t0() + (m << wu.log2_ul);
      row_pos[m] = mine && t < wu.len ? __ldg(smp.pos + wu.start + t) : -1;
    }
  }
  const int32_t* col = sm.r.col + wu.off;
  const float* val = sm.val + wu.off;
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  if constexpr (SAMPLED) {
    weigh_slots(wu, smp.k, smp.ra, smp.rb, row_deg, row_pos, vals != nullptr, sm.val);
    __syncwarp();
  }

  const RowLanes rl(wu, log2_g, f, f, VEC, static_cast<int>(blockIdx.y));
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; },
                                        [&](int j, const float (&v)[VEC]) {
                                          const float wj = round_to<T>(val[j]);
#pragma unroll
                                          for (int i = 0; i < VEC; ++i)
                                            acc[i] = fmaf(wj, v[i], acc[i]);
                                        });
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = sum_groups(acc[i], wu, rl);
  if (rl.sg != 0 || !rl.active || !wu.valid()) return;
  const size_t c0 = static_cast<size_t>(rl.vcol) * VEC;
  const int p = wu.part(unit_part);
  if (p >= 0) {
    store_vec<VEC>(part + static_cast<size_t>(p) * f + c0, acc);
    return;
  }
  const int node = wu.node(unit_node);
  const size_t o = static_cast<size_t>(node) * f + c0;
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

template <int VEC, class T, bool SAMPLED>
int launch(const T* x, const int32_t* cols, const float* vals, const int64_t* unit_start,
           const int32_t* unit_len, const int32_t* unit_node, const int32_t* unit_part,
           const int32_t* warp_first, const int32_t* split_node, const int32_t* split_first,
           const int32_t* split_count, const float* diag, T* out, float* part, int n_warps,
           int n_split, int f, int log2_g, const Sampling& smp, cudaStream_t st) {
  int l;  // log2_g, which the caller checked
  dim3 grid;
  reduce_grid(n_warps, f, VEC, &l, &grid);
  spmm_unit_kernel<VEC, T, SAMPLED><<<grid, kWarp * kWarpsPerBlock, kBlockSmem, st>>>(
      x, cols, vals, unit_start, unit_len, unit_node, unit_part, warp_first, diag, out, part,
      n_warps, f, log2_g, smp);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 0) return err;
  // the merge reads 4 columns a thread wherever the rows hold them
  constexpr int MV = VEC == 8 ? 4 : VEC;
  spmm_merge_kernel<MV, T><<<n_split, kMergeThreads, 0, st>>>(x, part, split_node, split_first,
                                                              split_count, diag, out, f);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int run(const void* x, const void* cols, const void* vals, const void* unit_start,
        const void* unit_len, const void* unit_node, const void* unit_part,
        const void* warp_first, const void* split_node, const void* split_first,
        const void* split_count, const void* diag, void* out, void* part, int n_warps,
        int n_split, int n_out, int zero_from, int f, int vec, int log2_g, const Sampling* smp,
        void* stream) {
  if (f <= 0 || n_out <= 0) return 0;
  const bool wide = std::is_same_v<T, bf16> && vec == 8;
  if ((vec != 1 && vec != 4 && !wide) || f % vec != 0 || log2_g != row_lanes(f / vec) ||
      ((warp_first == nullptr) != (log2_g >= kPackedLanes)) || zero_from < 0 ||
      (n_warps <= 0 && zero_from != 0) || (smp == nullptr && vals == nullptr) ||
      (smp != nullptr && (smp->k < 0 || smp->ra < 0 || smp->rb < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows that no unit writes (padding) are 0
  int err = 0;
  if (zero_from < n_out) {
    const size_t row = static_cast<size_t>(f) * sizeof(T);
    err = static_cast<int>(cudaMemsetAsync(static_cast<char*>(out) + zero_from * row, 0,
                                           (n_out - zero_from) * row,
                                           static_cast<cudaStream_t>(stream)));
  }
  if (err != 0 || n_warps <= 0) return err;
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto go = [&](auto vec_tag) {
    const auto form = [&](auto sampled_tag) {
      return launch<decltype(vec_tag)::value, T, decltype(sampled_tag)::value>(
          static_cast<const T*>(x), i32(cols), f32(vals),
          static_cast<const int64_t*>(unit_start), i32(unit_len), i32(unit_node),
          i32(unit_part), i32(warp_first), i32(split_node), i32(split_first), i32(split_count),
          f32(diag), static_cast<T*>(out), static_cast<float*>(part), n_warps, n_split, f,
          log2_g, smp != nullptr ? *smp : Sampling{}, static_cast<cudaStream_t>(stream));
    };
    return smp != nullptr ? form(std::true_type{}) : form(std::false_type{});
  };
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec == 8) return go(std::integral_constant<int, 8>{});
  }
  return vec == 4 ? go(std::integral_constant<int, 4>{}) : go(std::integral_constant<int, 1>{});
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; diag
// may be null, and part (n_partials, f) f32 scratch is read only when
// n_split > 0.  Rows [zero_from, n_out) of out (n_out, f) are set to 0
// first (one cudaMemsetAsync: the caller allocates out uninitialised);
// zero_from is WorkUnits.n_written (clipped to n_out), below which every
// row is some unit's node, and 0 without units.  The unit and split
// tables are ops/graph.py WorkUnits': unit_start int64, the others int32; warp_first is the warp table of
// this call's g = 2^log2_g lanes across a row (WorkUnits.warps: null at
// log2_g = 5, where warp w takes unit w) and n_warps its warp count.
// `vec` is 4 (F % 4 == 0 and x and out aligned to 4 elements), 8 at bf16
// (F % 8 == 0, aligned to 8), or 1; log2_g must be row_lanes(F / vec).
// Launches pass 1 and, when a row is split, pass 2 on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
// gala_bell_spmm_f32: x and out f32; gala_bell_spmm_bf16: x and out bf16.
// vals and diag are f32 in both.
#define GALA_BELL_SPMM(NAME, T)                                                               \
  extern "C" int NAME(const void* x, const void* cols, const void* vals,                       \
                      const void* unit_start, const void* unit_len, const void* unit_node,     \
                      const void* unit_part, const void* warp_first, const void* split_node,   \
                      const void* split_first, const void* split_count, const void* diag,      \
                      void* out, void* part, int n_warps, int n_split, int n_out,              \
                      int zero_from, int f, int vec, int log2_g, void* stream) {               \
    return run<T>(x, cols, vals, unit_start, unit_len, unit_node, unit_part, warp_first,       \
                  split_node, split_first, split_count, diag, out, part, n_warps, n_split,     \
                  n_out, zero_from, f, vec, log2_g, nullptr, stream);                          \
  }
GALA_BELL_SPMM(gala_bell_spmm_f32, float)
GALA_BELL_SPMM(gala_bell_spmm_bf16, bf16)

// The sampled form (dynamic neighbor sampling): the same call with the
// slot values replaced by the sampling weights, computed in pass 1's
// staging.  deg and pos (S,) int32 are the layout's per-slot row degree
// and in-row position (ops/graph.py DynSlots), in flat_vals order; vals
// (S,) f32 the structural values the weights multiply, or null (a value
// of 1); k >= 0 picks (ra*i + rb) mod deg, i < k, with ra, rb >= 0 and
// ra*(k-1) + rb within int32.
#define GALA_BELL_SPMM_DYN(NAME, T)                                                           \
  extern "C" int NAME(const void* x, const void* cols, const void* vals, const void* deg,      \
                      const void* pos, const void* unit_start, const void* unit_len,           \
                      const void* unit_node, const void* unit_part, const void* warp_first,    \
                      const void* split_node, const void* split_first, const void* split_count, \
                      const void* diag, void* out, void* part, int n_warps, int n_split,       \
                      int n_out, int zero_from, int f, int vec, int log2_g, int k, int ra,     \
                      int rb, void* stream) {                                                  \
    const Sampling smp{static_cast<const int32_t*>(deg), static_cast<const int32_t*>(pos), k,  \
                       ra, rb};                                                                \
    return run<T>(x, cols, vals, unit_start, unit_len, unit_node, unit_part, warp_first,       \
                  split_node, split_first, split_count, diag, out, part, n_warps, n_split,     \
                  n_out, zero_from, f, vec, log2_g, &smp, stream);                             \
  }
GALA_BELL_SPMM_DYN(gala_bell_spmm_dyn_f32, float)
GALA_BELL_SPMM_DYN(gala_bell_spmm_dyn_bf16, bf16)

// Launch limits of the library's kernels, four ints each in `out`:
// registers per thread, static and dynamic shared memory per block,
// resident blocks per SM.  Kernel k: 0 pass 1 (float4), 1 pass 1
// (scalar), 2 pass 2 (float4), 3 pass 2 (scalar); 4-7 the same at bf16
// (pass 1 with 8-byte loads of 4 columns); 8 pass 1 at bf16 with 16-byte
// loads of 8 columns; 9-13 the sampled pass 1 (float4, scalar, then at
// bf16 4, 1 and 8 columns).  Returns the CUDA error, 0 on success.
extern "C" int gala_bell_spmm_limits(int k, int* out) {
  const int block = kWarp * kWarpsPerBlock;
  switch (k) {
    case 0: return launch_limits(spmm_unit_kernel<4, float, false>, block, kBlockSmem, out);
    case 1: return launch_limits(spmm_unit_kernel<1, float, false>, block, kBlockSmem, out);
    case 2: return launch_limits(spmm_merge_kernel<4, float>, kMergeThreads, 0, out);
    case 3: return launch_limits(spmm_merge_kernel<1, float>, kMergeThreads, 0, out);
    case 4: return launch_limits(spmm_unit_kernel<4, bf16, false>, block, kBlockSmem, out);
    case 5: return launch_limits(spmm_unit_kernel<1, bf16, false>, block, kBlockSmem, out);
    case 6: return launch_limits(spmm_merge_kernel<4, bf16>, kMergeThreads, 0, out);
    case 7: return launch_limits(spmm_merge_kernel<1, bf16>, kMergeThreads, 0, out);
    case 8: return launch_limits(spmm_unit_kernel<8, bf16, false>, block, kBlockSmem, out);
    case 9: return launch_limits(spmm_unit_kernel<4, float, true>, block, kBlockSmem, out);
    case 10: return launch_limits(spmm_unit_kernel<1, float, true>, block, kBlockSmem, out);
    case 11: return launch_limits(spmm_unit_kernel<4, bf16, true>, block, kBlockSmem, out);
    case 12: return launch_limits(spmm_unit_kernel<1, bf16, true>, block, kBlockSmem, out);
    case 13: return launch_limits(spmm_unit_kernel<8, bf16, true>, block, kBlockSmem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
