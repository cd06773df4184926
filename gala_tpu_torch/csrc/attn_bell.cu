// Fused slot-space graph attention for NVIDIA Hopper (sm_90a): the
// forward and both backward passes of the GAT path's attention_aggregate
// (gala_tpu_torch/ops/attention.py), on the binned-ELL attention layouts.
//
// Replaces gala_tpu/ops/pallas/attn_bell.py:
//   attn_fwd_kernel   <- attn_fwd_planned  (kernel `_kernel`)
//   attn_bwd1_kernel  <- attn_bwd1_planned (kernel `_bwd1_kernel`)
//   attn_bwd2_kernel  <- attn_bwd2_planned (kernel `_bwd2_kernel`)
// with the semantics of gala_tpu/ops/attention.py (_head_softmax_pos,
// _head_bwd_stats, _slot_grads), for H heads of width fh = hf / H:
//   zpre = vl[c, h] + vr[r, h],   z = leaky_relu(zpre)   (edge c -> r)
//   p    = masked softmax of z over each destination r's slots
//   out[r, h*fh:(h+1)*fh] = sum_c p * x[c, h*fh:(h+1)*fh]
// The TPU kernels run one degree-class segment per call and emit
// per-virtual-row partials for hub nodes, which XLA merges with segment
// ops.  Here each kernel covers a whole layout in one call of two
// launches over the layout's work units (ops/graph.py WorkUnits;
// unit_gather.cuh), as the bell SpMM does.  The forward:
//   pass 1  several short units a warp, as the SpMM takes them (a hub's
//           128-slot units one a warp): each unit's softmax statistics
//           (one max and two sums per head for the whole unit, not per
//           32-slot chunk), then its weighted gather of x.  A unit that
//           is its whole row writes
//           out, m, s (and out+, s+); a unit of a longer row (a hub: its
//           units are its virtual rows) writes the unnormalised partial
//           (m_u, s_u, s+_u, acc_u, acc+_u), the TPU kernel's
//           normalize=False output.
//   pass 2  one block per split row merges its partials in unit order by
//           gala_tpu's online-softmax rescaling (attention.py:663-695):
//           m = max(m_u, floor), s = sum s_u e^(m_u - m), the same for
//           acc, s+ and acc+; s = 1 where the sum is 0; out = acc / s.
// bwd2, on the transpose layout (rows = sources c, slots = destinations
// r), over that layout's units:
//   pass 1  several short units a warp, as the forward takes them: p from
//           each destination's saved [vr | m | s | sds], then one gather
//           of the destinations' dout slices that sums dx = sum p dout and
//           q = sum p lrelu' dout together; dvl = <q, x[c]> - sum p lrelu'
//           sds once per unit (x[c] is one row for the whole unit).  A
//           whole row writes [dx | dvl]; a unit of a split row writes that
//           plain partial.
//   pass 2  one block per split row sums its partials in unit order.
// bwd1 (off the GAT path: it takes the flash identity), on the fwd
// layout's units, with the rows' saved (m, s):
//   pass 1  the forward's warps, scalar and gather phases under the row's
//           max m_r (no max, no rescaling), so one read of each x[c] slice
//           sums acc = sum p x and acc+ = sum_{zpre>0} p x; then sds =
//           <dout[r], acc> and A = slope sds + (1 - slope) <dout[r], acc+>
//           once per unit (dout[r] is one row for the whole unit), B from
//           the probabilities' two sums.  A whole row writes [sds | A | B];
//           a unit of a split row that plain partial.
//   pass 2  bwd2's: one block per split row sums its partials in unit
//           order.
// No atomics: every sum is taken in a fixed order, so results are
// deterministic.
//
// What bounds them on the H100: bytes.  Per real slot the forward reads
// 8 bytes of (col, occupancy), H scores of vl and one hf-wide row of x;
// bwd2 reads 8 bytes of (col, occupancy) and one (hf + 4H)-wide row
// [dout | vr | m | s | sds] of the destination, once (hf / H + 4H wide
// for the gradient of a mean over the heads, whose one dout block every
// head reads: 1,536 -> 304 B a slot at 8 heads of 41, pitch 44); bwd1
// what the forward reads, and writes 3H floats a row.  There are a few
// flops per gathered float (an exp per slot and head), and no tile is
// reused, so tensor cores have no role.  In 32-byte sector requests a
// real slot costs, at 8 heads on the GAT paper's two layers (8 of 8, 8 of
// 41 at pitch 44: 64 and 352 columns): the forward 8 + 8 and 24 + 44 (a
// head's score a request, head by head, in each of the wide layer's 3
// slices) before the heads went across lanes, 1 + 8 and 1 + 44 after;
// bwd2 32 + 8 and 32 + 44 (vr, m, s and sds a request each, head by
// head) before, 4 + 8 and 4 + 44 after.  What is left is the row's
// gather; how much of it L2 serves was not read (no hardware counters on
// the card), and the wide layer's 0.88 against a predicted 0.65 suggests
// its scalar reads had been L2 hits.
// One design for the three pass-1 kernels.  Three units in four hold at
// most 8 slots, and one warp a unit paid each one's whole chain
// (descriptor, scores, a max and two sums over the whole warp, gather,
// store) for a few rows.  So a warp takes G units (unit_gather.cuh
// WarpUnits, from the layout's warp table for its g); a unit's 32 / G
// lanes stage its columns (one coalesced sweep of the warp where the units
// lie back to back), then take its scalar phase through shared memory
// (the forward's scores, max and two sums; bwd1's probabilities under the
// saved max and two sums; bwd2's probabilities and sum p lrelu' sds),
// then its gather with lanes across the features, its slot groups summed
// by a shuffle tree inside its lanes (gather_units, sum_groups).  The
// forward's and bwd2's scalar lanes take (slot, head) (HeadLanes:
// neighbouring lanes the heads of one slot, so a slot's H scores are one
// coalesced read; at one head the unit's slots, through the same code in
// bwd2 and a loop of its own in the forward), each lane keeps its head's
// running max and sums, and the slot lanes of a head reduce them, once
// for all heads.  Lane t0 = h of the unit keeps head h's result in a
// register: no per-head register arrays, no per-unit sums in shared
// memory.  bwd1 (off the GAT path) keeps its
// scalar phase head by head: its kernel phase is the only caller, so the
// multi-head lanes would change what no cell runs.  bwd1's and bwd2's
// dots with one row per unit (dout[r], x[c]) are summed over each head's
// lanes and kept by lane t0 = h; a wide row's g-vector slices are walked
// inside the warp (n_slices), so a head that straddles two slices is
// summed whole; the one-head forward takes its slice from blockIdx.y,
// the multi-head forward walks them too, so a wide row stages its
// columns and takes its scalar phase once.  Each kernel is instantiated
// for one head (6 blocks per SM, 40 registers: at 32 they spilled) and
// for up to 8 (5 blocks, 48 registers; the bf16 forward's 8-column form
// 4 blocks, 56).
// Measured (scripts/unit_kernels_torch.py, in turns with the tree
// before each change, PERF.md; NVIDIA H100 80GB HBM3 at 700 W), f32 ms.
// Several units a warp against one, at hf = 32 / 40 and one head: the
// forward 0.2087 -> 0.1278 / 0.2326 -> 0.1907; bwd2 0.1566 -> 0.0972 /
// 0.1790 -> 0.1427; bwd1 0.1334 -> 0.0920 / 0.1518 -> 0.1492.  The heads
// across lanes against head by head, 8 heads at hf = 64 / 328 (pitch 44)
// on the benchmark's Reddit-shaped graph: the forward
// 12.25 -> 8.23 / 52.91 -> 45.76, bwd2 31.21 -> 9.85 / 51.79 -> 45.64;
// on the Arxiv stand-in: the forward 0.4512 -> 0.2663 / 3.4993 ->
// 2.4611, bwd2 0.5809 -> 0.2668 / 2.2844 -> 2.0250.
//
// bf16 activations (gala_tpu's dtype=jnp.bfloat16): each kernel has a
// second instantiation that reads x, vl and vr (and bwd1's dout) as bf16,
// widened to f32 in registers: the forward 16-byte loads of 8 columns a
// lane (8-byte loads of 4 where fh % 8 != 0), bwd1 8-byte loads of 4, and
// bwd2 16-byte loads of its f32 table with 8-byte loads of 4 of its one
// x[c] row a unit.  Everything else stays f32 as gala_tpu keeps it
// (ops/attention.py:405-407, 763-768, 826-838): the scores, p, m, s, the
// partials and both merges, the outputs (out, out+, s+; bwd1's [sds | A |
// B]; bwd2's [dx | dvl]) and bwd2's [dout | vr | m | s | sds] table.  The
// forward's x rows are half the bytes; bwd2's reads of x and vl (one row
// per unit, one value per head) are what gala_tpu upcasts to f32.
//
// Masked slots (occupancy 0: padding and the phantom column) are skipped
// without reading their rows.  Output rows that no unit or row writes
// (padding) are 0: each call zeroes them first (cudaMemsetAsync, from
// WorkUnits.n_written on: every row below it is some unit's node).

#include <math.h>

#include <initializer_list>

#include "unit_gather.cuh"

namespace {

using namespace gala;

constexpr int kMaxHeads = 8;
constexpr int kMergeThreads = 64;
constexpr float kNeg = -1e30f;    // masked score (gala_tpu's _NEG)
constexpr float kFloor = -5e29f;  // floor of a row's max, _NEG / 2

__device__ __forceinline__ float lrelu(float z, float slope) { return z > 0.f ? z : slope * z; }

// The dynamic shared memory per warp of the three pass-1 kernels: its
// units' columns, then H rows of kUnitSlots scores (the forward's), then
// probabilities, each stored with the sign of its zpre (+p where zpre > 0,
// -p elsewhere: the flash statistics' mask and lrelu' ride in the sign
// bit).  Rows of several heads lie head_stride floats apart: 4 more than
// kUnitSlots, so the heads of one slot fall in different banks (bank 4h +
// t), as the multi-head scalar phase writes them and the gathers read them.
__host__ __device__ constexpr int head_stride(int nh) {
  return nh == 1 ? kUnitSlots : kUnitSlots + 4;
}
__host__ __device__ constexpr size_t unit_warp_smem(int nh) {
  return sizeof(UnitSmem) + static_cast<size_t>(nh) * head_stride(nh) * sizeof(float);
}
static_assert(unit_warp_smem(kMaxHeads) * kWarpsPerBlock <= kDefaultSmem,
              "the unit kernels would need cudaFuncSetAttribute");

// The staging of a warp's units' columns into shared memory (col, the
// warp's share): a masked slot (occupancy 0: padding, the phantom column)
// is stored as -1 and its row is never read.
__device__ __forceinline__ void stage_columns(const WarpUnits& wu, const int32_t* __restrict__ cols,
                                              const float* __restrict__ occ, int32_t* col) {
  stage_units(wu, [&](int i, int64_t slot) {
    const int c = __ldg(cols + slot);
    col[i] = __ldg(occ + slot) != 0.f ? c : -1;
  });
}

// The scalar phase's lanes: a unit's ul lanes are HP head lanes (H
// rounded up to a power of two; HP <= g <= ul, as fh >= 4) by ul / HP slot
// lanes.  Lane t0 takes head h = t0 % HP (none where h >= H) and the unit's
// slots t0 / HP, t0 / HP + ul / HP, ...: neighbouring lanes take the heads
// of one slot, so its H scores (vl[c, 0:H]; bwd2's vr, m, s and sds blocks
// of its table row) are read as coalesced pieces.  A lane keeps a running
// max and sums of its head over its slots; the slot lanes of a head then
// reduce them (log2(ul / HP) shuffle steps, unit_max / unit_sum from
// stride HP), and lane t0 = h holds head h's results.  At one head (MAXH
// 1, HP = 1 at compile time) lane t0 takes slots t0, t0 + ul, ... and the
// reductions run over the whole unit.
template <int MAXH>
struct HeadLanes {
  int log2_hp, h, step;
  bool on;
  __device__ __forceinline__ HeadLanes(const WarpUnits& wu, int nh) {
    log2_hp = MAXH == 1 ? 0 : 32 - __clz(nh - 1);
    h = wu.t0() & ((1 << log2_hp) - 1);
    step = 1 << (wu.log2_ul - log2_hp);
    on = MAXH == 1 || h < nh;
  }
  __device__ __forceinline__ int first(const WarpUnits& wu) const { return wu.t0() >> log2_hp; }
  __device__ __forceinline__ int stop() const { return 1 << log2_hp; }
};

// Resident blocks per SM that the forward asks of the compiler: 6 (40
// registers; registers go in steps of 8 a thread, so 7 blocks would give
// 32).  At 8 heads the shared memory allows no more blocks; at 32
// registers the forward spilled (acc and acc+ are 2 VEC registers, 16 at 8
// bf16 columns a lane).  The multi-head form, which walks its slices,
// spilled 20-44 B at 40 registers, so it asks for 5 (48), as bwd1 and bwd2
// do at H > 1, and for 4 (56) at 8 bf16 columns a lane, which spilled 4 B
// at 48.
constexpr int kFwdMinBlocks = 6;
template <int VEC>
constexpr int kFwdMinBlocksHeads = VEC == 8 ? 4 : 5;
// rows of a slot group in flight per step of the gather
template <int VEC>
constexpr int kFwdRows = VEC == 4 ? 2 : 1;

// Forward pass 1: several short units a warp (unit_gather.cuh WarpUnits;
// one at g = 32).  With outpos != null the flash statistics out+ =
// sum_{zpre>0} p x and s+ = sum_{zpre>0} p are taken too.  The partial
// tables of split rows (unnormalised, p = e^(z - m_u)): pacc, paccp
// (n_partials, hf); pm, ps, psp (n_partials, H).  Two forms: one head
// (MAXH 1) and up to 8 (MAXH 8).
//
// Scalar phase, by the unit's ul = 32 / G lanes: the columns go to shared
// memory (-1 for a masked slot), then each lane's scores zpre = vl[c, h] +
// vr[node, h] of its head h (kept in the head's row of shared memory), the
// head's max m = max(max lrelu(zpre), kFloor) over the unit, and p =
// e^(lrelu(zpre) - m) stored with the sign of zpre over the score, with s
// = sum p and s+ = sum_{zpre>0} p; max and sums are reductions over the
// head's lanes, and lane t0 = h writes head h's statistics.  At H > 1 the
// lanes take (slot, head) (HeadLanes), all heads in one pass.  At one head
// a lane takes the unit's slots t0, t0 + ul, ... (at most 4, as a unit
// holds at most 4 ul slots) in a loop over the call's heads: HeadLanes at
// HP = 1 has the same lane map and order of sums, but written through it
// the 4-column forms spilled 4 B at 40 registers (one pass) or ran 0.9-1.3%
// slower (a loop of passes), so the one-head form keeps its own loop.  No
// per-head register arrays.  Gather phase: each slot group of the unit
// sums |p| x (and p x over p > 0) over its slots, summed over the unit's
// slot groups by a shuffle tree, and divided by the sum of the lane's
// head.  At one head a block takes one g-vector slice of its rows
// (blockIdx.y); at H > 1 the warp walks all n_slices of them, so a wide
// row stages its columns and takes its scalar phase once.
template <int VEC, int MAXH, class T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock,
                                  MAXH == 1 ? kFwdMinBlocks : kFwdMinBlocksHeads<VEC>)
attn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ vl,
                const T* __restrict__ vr, const int32_t* __restrict__ cols,
                const float* __restrict__ occ, const int64_t* __restrict__ unit_start,
                const int32_t* __restrict__ unit_len, const int32_t* __restrict__ unit_node,
                const int32_t* __restrict__ unit_part, const int32_t* __restrict__ warp_first,
                float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ s_out,
                float* __restrict__ outpos, float* __restrict__ spos_out,
                float* __restrict__ pacc, float* __restrict__ paccp, float* __restrict__ pm,
                float* __restrict__ ps, float* __restrict__ psp, int n_warps, int hf,
                int nh, float slope, int log2_g, int n_slices) {
  extern __shared__ float4 smem[];
  const int w = threadIdx.x / kWarp;
  WarpUnits wu;
  if (!warp_units(warp_first, blockIdx.x * kWarpsPerBlock + w, n_warps, unit_start, unit_len,
                  wu))
    return;  // the same for every lane of the warp
  char* base = reinterpret_cast<char*>(smem) + w * unit_warp_smem(nh);
  int32_t* col = reinterpret_cast<UnitSmem*>(base)->col;
  stage_columns(wu, cols, occ, col);
  col += wu.off;
  // [H][head_stride(H)]
  float* sh_p = reinterpret_cast<float*>(base + sizeof(UnitSmem)) + wu.off;
  const bool flash = outpos != nullptr;
  __syncwarp();

  // scalar phase: scores, max and sums (a lane of no unit, past the warp's
  // count, reads row 0 and takes no slot: its unit's node would lie past
  // the table's end in the last warp)
  const int node = wu.valid() ? wu.node(unit_node) : 0;
  float s_keep = 1.f;  // lane t0 < nh: head t0's sum (1 where it is 0)
  // head h's statistics, by the lane that holds them
  const auto write_stats = [&](int h, float m, float sum, float sump) {
    const int p = wu.part(unit_part);
    if (p >= 0) {  // a partial of a split row, unnormalised
      const size_t o = static_cast<size_t>(p) * nh + h;
      pm[o] = m;
      ps[o] = sum;
      if (flash) psp[o] = sump;
    } else {
      const float s_fin = sum > 0.f ? sum : 1.f;
      const size_t o = static_cast<size_t>(node) * nh + h;
      m_out[o] = m;
      s_out[o] = s_fin;
      if (flash) spos_out[o] = sump / s_fin;
    }
  };
  if constexpr (MAXH > 1) {
    const HeadLanes<MAXH> hl(wu, nh);
    float* ph = sh_p + hl.h * head_stride(MAXH);
    const float vr_h = hl.on ? ld(vr + static_cast<size_t>(node) * nh + hl.h) : 0.f;
    float m = kFloor;
    for (int t = hl.first(wu); hl.on && t < wu.len; t += hl.step) {
      const int c = col[t];
      if (c >= 0) {
        const float zp = ld(vl + static_cast<size_t>(c) * nh + hl.h) + vr_h;
        ph[t] = zp;
        m = fmaxf(m, lrelu(zp, slope));
      }
    }
    m = unit_max(m, wu, hl.stop());
    float sum = 0.f, sump = 0.f;
    for (int t = hl.first(wu); hl.on && t < wu.len; t += hl.step) {
      float p = 0.f;
      bool pos = false;
      if (col[t] >= 0) {
        const float zp = ph[t];
        p = expf(lrelu(zp, slope) - m);
        pos = zp > 0.f;
      }
      sum += p;
      if (pos) sump += p;
      ph[t] = pos ? p : -p;
    }
    sum = unit_sum(sum, wu, hl.stop());
    if (flash) sump = unit_sum(sump, wu, hl.stop());
    if (wu.t0() == hl.h && hl.on && wu.valid()) write_stats(hl.h, m, sum, sump);
    if (wu.t0() == hl.h) s_keep = sum > 0.f ? sum : 1.f;
  } else {
    const int ul = 1 << wu.log2_ul;
    for (int h = 0; h < nh; ++h) {
      float* ph = sh_p + h * kUnitSlots;
      const float vr_h = ld(vr + static_cast<size_t>(node) * nh + h);
      float m = kFloor;
      for (int t = wu.t0(); t < wu.len; t += ul) {
        const int c = col[t];
        if (c >= 0) {
          const float zp = ld(vl + static_cast<size_t>(c) * nh + h) + vr_h;
          ph[t] = zp;
          m = fmaxf(m, lrelu(zp, slope));
        }
      }
      m = unit_max(m, wu);
      float sum = 0.f, sump = 0.f;
      for (int t = wu.t0(); t < wu.len; t += ul) {
        float p = 0.f;
        bool pos = false;
        if (col[t] >= 0) {
          const float zp = ph[t];
          p = expf(lrelu(zp, slope) - m);
          pos = zp > 0.f;
        }
        sum += p;
        if (pos) sump += p;
        ph[t] = pos ? p : -p;
      }
      sum = unit_sum(sum, wu);
      if (flash) sump = unit_sum(sump, wu);
      if (wu.t0() == h && wu.valid() && blockIdx.y == 0) write_stats(h, m, sum, sump);
      if (wu.t0() == h) s_keep = sum > 0.f ? sum : 1.f;
    }
  }
  __syncwarp();

  // gather phase of g-vector slice y; acc and acc+ are reused slice by slice
  const auto gather_slice = [&](int y) {
    const RowLanes rl(wu, log2_g, hf, hf / nh, VEC, y);
    // the sum of the lane's head, from the lane that keeps it
    const float s_hd = __shfl_sync(kFullMask, s_keep, (wu.ui() << wu.log2_ul) + rl.hd);
    float acc[VEC], accp[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = accp[i] = 0.f;
    const float* php = sh_p + rl.hd * head_stride(MAXH);
    gather_units<VEC, kFwdRows<VEC>>(col, wu, rl, x, hf, [&](int j) { return php[j] != 0.f; },
                                     [&](int j, const float (&v)[VEC]) {
                                       const float pv = php[j];
                                       const float p = fabsf(pv);
#pragma unroll
                                       for (int i = 0; i < VEC; ++i)
                                         acc[i] = fmaf(p, v[i], acc[i]);
                                       if (flash && pv > 0.f) {
#pragma unroll
                                         for (int i = 0; i < VEC; ++i)
                                           accp[i] = fmaf(pv, v[i], accp[i]);
                                       }
                                     });
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] = sum_groups(acc[i], wu, rl);
      if (flash) accp[i] = sum_groups(accp[i], wu, rl);
    }
    if (rl.sg != 0 || !rl.active || !wu.valid()) return;
    const size_t c0 = static_cast<size_t>(rl.vcol) * VEC;
    const int p = wu.part(unit_part);
    if (p >= 0) {  // a partial of a split row, unnormalised
      const size_t o = static_cast<size_t>(p) * hf + c0;
      store_vec<VEC>(pacc + o, acc);
      if (flash) store_vec<VEC>(paccp + o, accp);
      return;
    }
    const size_t o = static_cast<size_t>(wu.node(unit_node)) * hf + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] /= s_hd;
    store_vec<VEC>(out + o, acc);
    if (flash) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) accp[i] /= s_hd;
      store_vec<VEC>(outpos + o, accp);
    }
  };
  if constexpr (MAXH == 1) {
    gather_slice(static_cast<int>(blockIdx.y));
  } else {
    for (int y = 0; y < n_slices; ++y) gather_slice(y);
  }
}

// Forward pass 2: one block per split row, its partials merged in unit
// order by the online-softmax rescaling.  A partial whose slots were all
// masked holds m_u = kFloor, s_u = 0, acc_u = 0: it adds 0, and a row of
// such partials only gets m = kFloor, s = 1, out = 0.
__global__ void __launch_bounds__(kMergeThreads)
attn_fwd_merge_kernel(const float* __restrict__ pacc, const float* __restrict__ paccp,
                      const float* __restrict__ pm, const float* __restrict__ ps,
                      const float* __restrict__ psp, const int32_t* __restrict__ split_node,
                      const int32_t* __restrict__ split_first,
                      const int32_t* __restrict__ split_count, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ s_out,
                      float* __restrict__ outpos, float* __restrict__ spos_out, int hf, int nh) {
  __shared__ float sh_m[kMaxHeads], sh_s[kMaxHeads];
  const bool flash = outpos != nullptr;
  const int node = split_node[blockIdx.x];
  const int first = split_first[blockIdx.x];
  const int count = split_count[blockIdx.x];
  if (threadIdx.x < nh) {
    const int h = threadIdx.x;
    float m = kFloor;
    for (int u = 0; u < count; ++u) m = fmaxf(m, pm[static_cast<size_t>(first + u) * nh + h]);
    float s = 0.f, sp = 0.f;
    for (int u = 0; u < count; ++u) {
      const size_t o = static_cast<size_t>(first + u) * nh + h;
      const float sc = expf(pm[o] - m);
      s = fmaf(ps[o], sc, s);
      if (flash) sp = fmaf(psp[o], sc, sp);
    }
    s = s > 0.f ? s : 1.f;
    sh_m[h] = m;
    sh_s[h] = s;
    const size_t o = static_cast<size_t>(node) * nh + h;
    m_out[o] = m;
    s_out[o] = s;
    if (flash) spos_out[o] = sp / s;
  }
  __syncthreads();
  const int fh = hf / nh;
  for (int c = threadIdx.x; c < hf; c += kMergeThreads) {
    const int h = c / fh;
    float acc = 0.f, accp = 0.f;
    for (int u = 0; u < count; ++u) {
      const size_t r = static_cast<size_t>(first + u);
      const float sc = expf(pm[r * nh + h] - sh_m[h]);
      acc = fmaf(pacc[r * hf + c], sc, acc);
      if (flash) accp = fmaf(paccp[r * hf + c], sc, accp);
    }
    const size_t o = static_cast<size_t>(node) * hf + c;
    out[o] = acc / sh_s[h];
    if (flash) outpos[o] = accp / sh_s[h];
  }
}

// The sum of a per-lane dot v over each head's lanes of the lanes' g-vector
// slice (hd the head of a lane's vector; one head needs no head index),
// added to `keep` by lane t0 = h of each unit: slice by slice, a dot over
// a whole head.  Every lane of the warp calls it.
template <int MAXH>
__device__ __forceinline__ void keep_head_sums(const WarpUnits& wu, const RowLanes& rl, int heads,
                                               float v, float& keep) {
  for (int h = 0; h < (MAXH == 1 ? 1 : heads); ++h) {
    float d = rl.active && (MAXH == 1 || rl.hd == h) ? v : 0.f;
    for (int off = (1 << rl.log2_g) >> 1; off > 0; off >>= 1)
      d += __shfl_xor_sync(kFullMask, d, off);
    if (wu.t0() == h) keep += d;
  }
}

// Rows of a slot group in flight per step of bwd1's and bwd2's gathers,
// and the resident blocks per SM that their one-head and multi-head forms
// ask of the compiler: the forward's 6 (40 registers) and 5 (48).  None
// spills (scripts/unit_variants_torch.py, PERF.md, on an H100 80GB HBM3
// at 700 W): at 8 blocks (32 registers) bwd2's one-head 4-column form
// spilled 24 B and bwd1's 8-56 B; bwd1's one-head 4-column form spills 28
// B at 2 rows in flight, so it keeps 1.
template <int MAXH>
constexpr int kBwd1Rows = MAXH == 1 ? 1 : 2;
constexpr int kBwd2Rows = 2;
constexpr int kBwd1MinBlocks = 6;
constexpr int kBwd1MinBlocksHeads = 5;
constexpr int kBwd2MinBlocks = 6;
constexpr int kBwd2MinBlocksHeads = 5;  // at 8 heads 36,864 B of shared memory a block: 6 fit

// Backward pass 1, pass 1: the forward's warps of units of the fwd layout
// (a unit reads up to 128 sources c of one destination r).  With the
// row's saved (m, s), p = e^(lrelu(zpre) - m_r) / s_r and lr' =
// lrelu'(zpre) = slope + (1 - slope) [zpre > 0]:
//   sds = sum p <dout[r], x[c]>        = <dout[r], acc> / s_r
//   A   = sum p lr' <dout[r], x[c]>    = slope sds + (1 - slope) <dout[r], acc+> / s_r
//   B   = sum p lr'                    = (slope s + (1 - slope) s+) / s_r
// where acc = sum e^(lrelu(zpre) - m_r) x[c], acc+ the same over zpre > 0,
// s and s+ the matching sums of e^(lrelu(zpre) - m_r): the forward's
// scalar and gather phases under the row's max (dout[r] is the same for
// every slot of the row, so each x[c] slice is read once and dout[r]'s
// once per unit).  Output row [sds | A | B] (3H wide) goes to the node's
// row of `out` for a unit that is its whole row, else to the unit's
// partial row of `part` (plain partial sums: p is already the row's, as
// in gala_tpu's per-virtual-row partials).  The warp walks all n_slices
// g-vector slices of the row, so each head's dot sees the whole head.
//
// Scalar phase, by the unit's lanes, head by head: p stored with the sign
// of zpre, s and s+ as sums over the unit's lanes, lane t0 = h keeping
// slope s + (1 - slope) s+ (b_keep).  Gather phase: acc and acc+ by each
// slot group, summed over the unit's slot groups, then the two dots with
// the lane's dout[r] vector, summed over each head's lanes and kept by
// lane t0 = h (sds_keep, pdp_keep).
template <int VEC, int MAXH, class T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock,
                                  MAXH == 1 ? kBwd1MinBlocks : kBwd1MinBlocksHeads)
attn_bwd1_kernel(const T* __restrict__ x, const T* __restrict__ vl,
                 const T* __restrict__ vr, const T* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ s,
                 const int32_t* __restrict__ cols, const float* __restrict__ occ,
                 const int64_t* __restrict__ unit_start, const int32_t* __restrict__ unit_len,
                 const int32_t* __restrict__ unit_node, const int32_t* __restrict__ unit_part,
                 const int32_t* __restrict__ warp_first, float* __restrict__ out,
                 float* __restrict__ part, int n_warps, int hf, int nh, float slope, int log2_g,
                 int n_slices) {
  extern __shared__ float4 smem[];
  const int w = threadIdx.x / kWarp;
  WarpUnits wu;
  if (!warp_units(warp_first, blockIdx.x * kWarpsPerBlock + w, n_warps, unit_start, unit_len,
                  wu))
    return;  // the same for every lane of the warp
  const int heads = MAXH == 1 ? 1 : nh;
  char* base = reinterpret_cast<char*>(smem) + w * unit_warp_smem(heads);
  int32_t* col = reinterpret_cast<UnitSmem*>(base)->col;
  stage_columns(wu, cols, occ, col);
  col += wu.off;
  // [H][head_stride(H)]
  float* sh_p = reinterpret_cast<float*>(base + sizeof(UnitSmem)) + wu.off;
  const int ul = 1 << wu.log2_ul;
  __syncwarp();

  // scalar phase: head by head, the forward's under the row's saved max
  // (a lane of no unit reads row 0 and takes no slot)
  float b_keep = 0.f;
  for (int h = 0; h < heads; ++h) {
    const size_t o = static_cast<size_t>(wu.valid() ? wu.node(unit_node) : 0) * heads + h;
    const float vr_h = ld(vr + o);
    const float m_r = __ldg(m + o);
    float sp = 0.f, spp = 0.f;
    for (int t = wu.t0(); t < wu.len; t += ul) {
      const int c = col[t];
      float p = 0.f;
      bool pos = false;
      if (c >= 0) {
        const float zp = ld(vl + static_cast<size_t>(c) * heads + h) + vr_h;
        p = expf(lrelu(zp, slope) - m_r);
        pos = zp > 0.f;
      }
      sp += p;
      if (pos) spp += p;
      sh_p[h * head_stride(MAXH) + t] = pos ? p : -p;
    }
    sp = unit_sum(sp, wu);
    spp = unit_sum(spp, wu);
    if (wu.t0() == h) b_keep = fmaf(slope, sp, (1.f - slope) * spp);
  }
  __syncwarp();

  float sds_keep = 0.f, pdp_keep = 0.f;
  for (int y = 0; y < n_slices; ++y) {
    // gather phase: the forward's, acc and acc+ from one read of each x[c]
    // slice; at one head the probabilities need no head index
    const RowLanes rl(wu, log2_g, hf, hf / heads, VEC, y);
    float acc[VEC], accp[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = accp[i] = 0.f;
    const float* ph = MAXH == 1 ? sh_p : sh_p + rl.hd * head_stride(MAXH);
    gather_units<VEC, kBwd1Rows<MAXH>>(col, wu, rl, x, hf, [&](int j) { return ph[j] != 0.f; },
                                     [&](int j, const float (&v)[VEC]) {
                                       const float pv = ph[j];
                                       const float p = fabsf(pv);
#pragma unroll
                                       for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, v[i], acc[i]);
                                       if (pv > 0.f) {
#pragma unroll
                                         for (int i = 0; i < VEC; ++i)
                                           accp[i] = fmaf(pv, v[i], accp[i]);
                                       }
                                     });
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] = sum_groups(acc[i], wu, rl);
      accp[i] = sum_groups(accp[i], wu, rl);
    }
    // <dout[r], acc> and <dout[r], acc+> on the lane's vector, from one
    // read of the unit's dout slice, then over each head's lanes
    float d = 0.f, dp = 0.f;
    if (rl.active && wu.valid()) {
      float dv[VEC];
      load_vec<VEC>(dout + static_cast<size_t>(wu.node(unit_node)) * hf +
                        static_cast<size_t>(rl.vcol) * VEC,
                    dv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        d = fmaf(acc[i], dv[i], d);
        dp = fmaf(accp[i], dv[i], dp);
      }
    }
    keep_head_sums<MAXH>(wu, rl, heads, d, sds_keep);
    keep_head_sums<MAXH>(wu, rl, heads, dp, pdp_keep);
  }
  const int h = wu.t0();
  if (h >= heads || !wu.valid()) return;
  const int node = wu.node(unit_node);
  const int pr = wu.part(unit_part);
  float* orow = pr >= 0 ? part + static_cast<size_t>(pr) * 3 * heads
                        : out + static_cast<size_t>(node) * 3 * heads;
  const float s_r = __ldg(s + static_cast<size_t>(node) * heads + h);
  const float sds = sds_keep / s_r;
  orow[h] = sds;
  orow[heads + h] = fmaf(slope, sds, (1.f - slope) * (pdp_keep / s_r));
  orow[2 * heads + h] = b_keep / s_r;
}

// Backward pass 2, pass 1: the forward's warps of units, over the
// transpose layout (a unit reads up to 128 destinations r of one source
// c).  With p = e^(lrelu(zpre) - m_r) / s_r and lr' = lrelu'(zpre),
//   dx[c]     = sum_r p dout[r]
//   dvl[c, h] = sum_r p lr' (<dout[r, h], x[c, h]> - sds[r, h])
//             = <q_h, x[c, h]> - sum_r p lr' sds[r, h],  q = sum_r p lr' dout[r]
// (x[c] is the same for every slot of the row), so each destination row
// is read once: its scalars [vr | m | s | sds] in the scalar phase, its
// dout slice in the gather, which sums dx and q together.  Output row [dx
// | dvl] (hf + H wide) goes to the node's row of `out` for a unit that is
// its whole row, else to the unit's partial row of `part` (plain partial
// sums: the TPU kernel's per-virtual-row output).  The warp walks all
// n_slices g-vector slices of the row, so dvl's dot sees its whole head.
//
// Scalar phase, by the unit's lanes across (slot, head) (HeadLanes, as the
// forward's): p stored with the sign of zpre (+p where zpre > 0, -p
// elsewhere), sum p lr' sds a sum over the head's slot lanes kept by lane
// t0 = h (sds_keep).  Gather phase: dx and q by
// each slot group from the f32 table's dout slices (16-byte loads at
// either type), summed over the unit's slot groups; <q, x[c]> summed over
// each head's lanes and kept by lane t0 = h (dot_keep).
//
// The table's dout block is dout_w wide: hf, each head's own dout (at one
// head always), or hf / H at H > 1, one block that every head takes (the
// gradient of a mean over the heads, whose dout is the same for each): a
// lane of head hd then reads the block's column vcol * VEC - hd * dout_w,
// so every head's lanes read the same bytes of a row, from L1 or L2 after
// the first.  The values gathered, the lane map and the order of the sums
// are those of the per-head table that repeats the block H times.
template <int VEC, int MAXH, class T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock,
                                  MAXH == 1 ? kBwd2MinBlocks : kBwd2MinBlocksHeads)
attn_bwd2_kernel(const float* __restrict__ wtab, const T* __restrict__ x,
                 const T* __restrict__ vl, const int32_t* __restrict__ cols,
                 const float* __restrict__ occ, const int64_t* __restrict__ unit_start,
                 const int32_t* __restrict__ unit_len, const int32_t* __restrict__ unit_node,
                 const int32_t* __restrict__ unit_part, const int32_t* __restrict__ warp_first,
                 float* __restrict__ out, float* __restrict__ part, int n_warps, int hf, int nh,
                 float slope, int log2_g, int n_slices, int dout_w) {
  extern __shared__ float4 smem[];
  const int w = threadIdx.x / kWarp;
  WarpUnits wu;
  if (!warp_units(warp_first, blockIdx.x * kWarpsPerBlock + w, n_warps, unit_start, unit_len,
                  wu))
    return;  // the same for every lane of the warp
  const int heads = MAXH == 1 ? 1 : nh;
  char* base = reinterpret_cast<char*>(smem) + w * unit_warp_smem(heads);
  int32_t* col = reinterpret_cast<UnitSmem*>(base)->col;
  stage_columns(wu, cols, occ, col);
  col += wu.off;
  // [H][head_stride(H)]
  float* sh_p = reinterpret_cast<float*>(base + sizeof(UnitSmem)) + wu.off;
  const int dw = MAXH == 1 ? hf : dout_w;  // the dout block's width
  const bool shared = MAXH > 1 && dw != hf;
  const int wt = dw + 4 * heads;
  __syncwarp();

  // scalar phase (a lane of no unit reads row 0 and takes no slot): the
  // lanes of a slot read its [vr | m | s | sds] blocks, at one head by one
  // 16-byte load (hf and wt are multiples of 4 and wtab is 16-byte
  // aligned), at H > 1 four coalesced pieces of one row of the table
  const HeadLanes<MAXH> hl(wu, heads);
  const float vl_c =
      hl.on ? ld(vl + static_cast<size_t>(wu.valid() ? wu.node(unit_node) : 0) * heads + hl.h)
            : 0.f;
  float sp = 0.f;
  for (int t = hl.first(wu); hl.on && t < wu.len; t += hl.step) {
    const int r = col[t];
    float pv = 0.f;
    if (r >= 0) {
      const float* wr = wtab + static_cast<size_t>(r) * wt + dw + hl.h;
      float4 v;
      if constexpr (MAXH == 1) {
        v = __ldg(reinterpret_cast<const float4*>(wr));
      } else {
        v = make_float4(__ldg(wr), __ldg(wr + heads), __ldg(wr + 2 * heads),
                        __ldg(wr + 3 * heads));
      }
      const float zpre = vl_c + v.x;
      const float p = expf(lrelu(zpre, slope) - v.y) / v.z;
      const bool pos = zpre > 0.f;
      sp = fmaf(pos ? p : slope * p, v.w, sp);
      pv = pos ? p : -p;
    }
    sh_p[hl.h * head_stride(MAXH) + t] = pv;
  }
  sp = unit_sum(sp, wu, hl.stop());
  const float sds_keep = wu.t0() == hl.h ? sp : 0.f;
  __syncwarp();

  float dot_keep = 0.f;
  for (int y = 0; y < n_slices; ++y) {
    // gather phase: lanes across features; one read of each destination's
    // dout slice feeds dx += p v and q += p lr' v; a slot of weight 0
    // (masked, or underflowed) is not read
    const RowLanes rl(wu, log2_g, hf, hf / heads, VEC, y);
    float dx[VEC], q[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) dx[i] = q[i] = 0.f;
    const float* ph = MAXH == 1 ? sh_p : sh_p + rl.hd * head_stride(MAXH);
    gather_units<VEC, kBwd2Rows>(col, wu, rl, wtab, wt, [&](int j) { return ph[j] != 0.f; },
                                     [&](int j, const float (&v)[VEC]) {
                                       const float pv = ph[j];
                                       const float p = fabsf(pv);
                                       const float pl = pv > 0.f ? p : slope * p;
#pragma unroll
                                       for (int i = 0; i < VEC; ++i) {
                                         dx[i] = fmaf(p, v[i], dx[i]);
                                         q[i] = fmaf(pl, v[i], q[i]);
                                       }
                                     },
                                     shared ? rl.hd * dw : 0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dx[i] = sum_groups(dx[i], wu, rl);
      q[i] = sum_groups(q[i], wu, rl);
    }
    // <q, x[c]> on the lane's vector, then over each head's lanes; the
    // output row [dx | dvl] (the node's row of out, or the unit's partial
    // row) is addressed here, not held through the gather
    float d = 0.f;
    if (rl.active && wu.valid()) {
      const int c = wu.node(unit_node);
      float xv[VEC];
      load_vec<VEC>(x + static_cast<size_t>(c) * hf + static_cast<size_t>(rl.vcol) * VEC, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) d = fmaf(q[i], xv[i], d);
      if (rl.sg == 0) {
        const int pr = wu.part(unit_part);
        float* orow = pr >= 0 ? part + static_cast<size_t>(pr) * (hf + heads)
                              : out + static_cast<size_t>(c) * (hf + heads);
#pragma unroll
        for (int i = 0; i < VEC; ++i) orow[rl.vcol * VEC + i] = dx[i];  // rows of hf + H floats
      }
    }
    keep_head_sums<MAXH>(wu, rl, heads, d, dot_keep);
  }
  const int h = wu.t0();
  if (h >= heads || !wu.valid()) return;
  const int pr = wu.part(unit_part);
  float* orow = pr >= 0 ? part + static_cast<size_t>(pr) * (hf + heads)
                        : out + static_cast<size_t>(wu.node(unit_node)) * (hf + heads);
  orow[hf + h] = dot_keep - sds_keep;
}

// bwd1's and bwd2's pass 2: one block per split row; its partial rows
// (bwd1's [sds | A | B], bwd2's [dx | dvl], ow floats) summed in unit
// order (gala_tpu's big_vrow segment-sum).
__global__ void __launch_bounds__(kMergeThreads)
attn_merge_sum_kernel(const float* __restrict__ part, const int32_t* __restrict__ split_node,
                      const int32_t* __restrict__ split_first,
                      const int32_t* __restrict__ split_count, float* __restrict__ out, int ow) {
  const int node = split_node[blockIdx.x];
  const int first = split_first[blockIdx.x];
  const int count = split_count[blockIdx.x];
  for (int c = threadIdx.x; c < ow; c += kMergeThreads) {
    float acc = 0.f;
    for (int u = 0; u < count; ++u) acc += part[static_cast<size_t>(first + u) * ow + c];
    out[static_cast<size_t>(node) * ow + c] = acc;
  }
}

bool bad_shape(int hf, int nh, int vec) {
  return nh < 1 || nh > kMaxHeads || hf <= 0 || hf % nh != 0 || vec != 4 || (hf / nh) % 4 != 0;
}

// The grid of a backward pass 1 (and of the forward at H > 1): n_warps
// warps of units; each walks all the g-vector slices of a row itself
inline dim3 bwd_grid(int n_warps) {
  return dim3((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}
inline int n_slices(int hf, int vec, int log2_g) {
  return (hf / vec + (1 << log2_g) - 1) >> log2_g;
}

template <int VEC, int MAXH, class T>
int launch_fwd(const void* x, const void* vl, const void* vr, const void* cols, const void* occ,
               const void* unit_start, const void* unit_len, const void* unit_node,
               const void* unit_part, const void* warp_first, const void* split_node,
               const void* split_first, const void* split_count, void* out, void* m, void* s,
               void* outpos, void* spos, void* part, int n_warps, int n_split, int n_partials,
               int hf, int nh, float slope, int log2_g, cudaStream_t st) {
  const size_t smem = unit_warp_smem(nh) * kWarpsPerBlock;
  // the partial tables, one scratch block: acc, acc+ (P, hf); m, s, s+ (P, H)
  float* pacc = static_cast<float*>(part);
  const size_t ph = static_cast<size_t>(n_partials) * hf, pn = static_cast<size_t>(n_partials) * nh;
  float* paccp = pacc + ph;
  float* pm = paccp + ph;
  float* ps = pm + pn;
  float* psp = ps + pn;
  const auto t = [](const void* p) { return static_cast<const T*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  // one head: a block a g-vector slice of its warps' rows; more: the warp
  // walks the slices
  int l;  // log2_g, which the caller checked
  dim3 grid;
  reduce_grid(n_warps, hf, VEC, &l, &grid);
  if (MAXH > 1) grid.y = 1;
  attn_fwd_kernel<VEC, MAXH, T><<<grid, kWarp * kWarpsPerBlock, smem, st>>>(
      t(x), t(vl), t(vr), i32(cols), f32(occ), i64(unit_start), i32(unit_len),
      i32(unit_node), i32(unit_part), i32(warp_first), static_cast<float*>(out),
      static_cast<float*>(m), static_cast<float*>(s), static_cast<float*>(outpos),
      static_cast<float*>(spos), pacc, paccp, pm, ps, psp, n_warps, hf, nh, slope, log2_g,
      n_slices(hf, VEC, log2_g));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 0) return err;
  attn_fwd_merge_kernel<<<n_split, kMergeThreads, 0, st>>>(
      pacc, paccp, pm, ps, psp, i32(split_node), i32(split_first), i32(split_count),
      static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(s),
      static_cast<float*>(outpos), static_cast<float*>(spos), hf, nh);
  return static_cast<int>(cudaGetLastError());
}

// After a backward pass 1 (checked here): bwd1's or bwd2's pass 2, only
// when a row is split
int merge_sums(const void* part, const void* split_node, const void* split_first,
               const void* split_count, void* out, int n_split, int ow, cudaStream_t st) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 0) return err;
  attn_merge_sum_kernel<<<n_split, kMergeThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(split_node),
      static_cast<const int32_t*>(split_first), static_cast<const int32_t*>(split_count),
      static_cast<float*>(out), ow);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int MAXH, class T>
int launch_bwd1(const void* x, const void* vl, const void* vr, const void* dout, const void* m,
                const void* s, const void* cols, const void* occ, const void* unit_start,
                const void* unit_len, const void* unit_node, const void* unit_part,
                const void* warp_first, const void* split_node, const void* split_first,
                const void* split_count, void* out, void* part, int n_warps, int n_split, int hf,
                int nh, float slope, int log2_g, cudaStream_t st) {
  const size_t smem = unit_warp_smem(nh) * kWarpsPerBlock;
  const auto t = [](const void* p) { return static_cast<const T*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  attn_bwd1_kernel<VEC, MAXH, T><<<bwd_grid(n_warps), kWarp * kWarpsPerBlock, smem, st>>>(
      t(x), t(vl), t(vr), t(dout), f32(m), f32(s), i32(cols), f32(occ), i64(unit_start),
      i32(unit_len), i32(unit_node), i32(unit_part), i32(warp_first), static_cast<float*>(out),
      static_cast<float*>(part), n_warps, hf, nh, slope, log2_g, n_slices(hf, VEC, log2_g));
  return merge_sums(part, split_node, split_first, split_count, out, n_split, 3 * nh, st);
}

template <int VEC, int MAXH, class T>
int launch_bwd2(const void* wtab, const void* x, const void* vl, const void* cols,
                const void* occ, const void* unit_start, const void* unit_len,
                const void* unit_node, const void* unit_part, const void* warp_first,
                const void* split_node, const void* split_first, const void* split_count,
                void* out, void* part, int n_warps, int n_split, int hf, int nh, float slope,
                int log2_g, int dout_w, cudaStream_t st) {
  const size_t smem = unit_warp_smem(nh) * kWarpsPerBlock;
  const auto t = [](const void* p) { return static_cast<const T*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  const auto i64 = [](const void* p) { return static_cast<const int64_t*>(p); };
  attn_bwd2_kernel<VEC, MAXH, T><<<bwd_grid(n_warps), kWarp * kWarpsPerBlock, smem, st>>>(
      f32(wtab), t(x), t(vl), i32(cols), f32(occ), i64(unit_start), i32(unit_len),
      i32(unit_node), i32(unit_part), i32(warp_first), static_cast<float*>(out),
      static_cast<float*>(part), n_warps, hf, nh, slope, log2_g, n_slices(hf, VEC, log2_g),
      dout_w);
  return merge_sums(part, split_node, split_first, split_count, out, n_split, hf + nh, st);
}

// run(VEC, MAXH) for the instantiation that nh selects: 4-column loads,
// one head or up to kMaxHeads
template <class Run>
int dispatch(int nh, Run run) {
  using One = std::integral_constant<int, 1>;
  using Four = std::integral_constant<int, 4>;
  using Max = std::integral_constant<int, kMaxHeads>;
  return nh == 1 ? run(Four{}, One{}) : run(Four{}, Max{});
}

// Rows [zero_from, n_pad) of each (n_pad, width) f32 output set to 0 on st
// (rows that no unit writes: padding); null outputs are skipped.
int zero_rows(std::initializer_list<void*> outs, int width, int n_pad, int zero_from,
              cudaStream_t st) {
  const size_t skip = static_cast<size_t>(zero_from) * width * sizeof(float);
  const size_t bytes = static_cast<size_t>(n_pad > zero_from ? n_pad - zero_from : 0) * width *
                       sizeof(float);
  for (void* t : outs) {
    if (t == nullptr || bytes == 0) continue;
    const int err = static_cast<int>(cudaMemsetAsync(static_cast<char*>(t) + skip, 0, bytes, st));
    if (err != 0) return err;
  }
  return 0;
}

// What every unit kernel's call must hold of its warp tables and zeroing:
// log2_g = row_lanes(hf / vec), a warp table exactly below 32 lanes, and
// zero_from within the rows (0 where there are no units)
bool bad_units(int hf, int vec, int log2_g, const void* warp_first, int n_warps, int zero_from) {
  return log2_g != row_lanes(hf / vec) ||
         ((warp_first == nullptr) != (log2_g >= kPackedLanes)) || zero_from < 0 ||
         (n_warps <= 0 && zero_from != 0);
}

template <class T>
int fwd(const void* x, const void* vl, const void* vr, const void* cols, const void* occ,
        const void* unit_start, const void* unit_len, const void* unit_node,
        const void* unit_part, const void* warp_first, const void* split_node,
        const void* split_first, const void* split_count, void* out, void* m, void* s,
        void* outpos, void* spos, void* part, int n_warps, int n_split, int n_partials,
        int n_pad, int zero_from, int hf, int nh, float slope, int vec, int log2_g,
        void* stream) {
  const bool wide = std::is_same_v<T, bf16> && vec == 8 && nh >= 1 && hf % nh == 0 &&
                    (hf / nh) % 8 == 0 && nh <= kMaxHeads;
  if ((!wide && bad_shape(hf, nh, vec)) || ((outpos == nullptr) != (spos == nullptr)) ||
      (n_split > 0 && part == nullptr) ||
      bad_units(hf, vec, log2_g, warp_first, n_warps, zero_from))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows that no unit writes (padding) are 0
  const auto st = static_cast<cudaStream_t>(stream);
  int err = zero_rows({out, outpos}, hf, n_pad, zero_from, st);
  if (err == 0) err = zero_rows({m, s, spos}, nh, n_pad, zero_from, st);
  if (err != 0 || n_warps <= 0) return err;
  const auto run = [&](auto vec_tag) {
    return dispatch(nh, [&](auto, auto maxh_tag) {
      return launch_fwd<decltype(vec_tag)::value, decltype(maxh_tag)::value, T>(
          x, vl, vr, cols, occ, unit_start, unit_len, unit_node, unit_part, warp_first,
          split_node, split_first, split_count, out, m, s, outpos, spos, part, n_warps, n_split,
          n_partials, hf, nh, slope, log2_g, st);
    });
  };
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec == 8) return run(std::integral_constant<int, 8>{});
  }
  return run(std::integral_constant<int, 4>{});
}

template <class T>
int bwd1(const void* x, const void* vl, const void* vr, const void* dout, const void* m,
         const void* s, const void* cols, const void* occ, const void* unit_start,
         const void* unit_len, const void* unit_node, const void* unit_part,
         const void* warp_first, const void* split_node, const void* split_first,
         const void* split_count, void* out, void* part, int n_warps, int n_split, int n_pad,
         int zero_from, int hf, int nh, float slope, int vec, int log2_g, void* stream) {
  if (bad_shape(hf, nh, vec) || (n_split > 0 && part == nullptr) ||
      bad_units(hf, vec, log2_g, warp_first, n_warps, zero_from))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int err = zero_rows({out}, 3 * nh, n_pad, zero_from, st);
  if (err != 0 || n_warps <= 0) return err;
  return dispatch(nh, [&](auto vec_tag, auto maxh_tag) {
    return launch_bwd1<decltype(vec_tag)::value, decltype(maxh_tag)::value, T>(
        x, vl, vr, dout, m, s, cols, occ, unit_start, unit_len, unit_node, unit_part, warp_first,
        split_node, split_first, split_count, out, part, n_warps, n_split, hf, nh, slope, log2_g,
        st);
  });
}

template <class T>
int bwd2(const void* wtab, const void* x, const void* vl, const void* cols, const void* occ,
         const void* unit_start, const void* unit_len, const void* unit_node,
         const void* unit_part, const void* warp_first, const void* split_node,
         const void* split_first, const void* split_count, void* out, void* part, int n_warps,
         int n_split, int n_pad, int zero_from, int hf, int nh, float slope, int vec, int log2_g,
         int dout_w, void* stream) {
  if (bad_shape(hf, nh, vec) || (n_split > 0 && part == nullptr) ||
      bad_units(hf, vec, log2_g, warp_first, n_warps, zero_from) ||
      (dout_w != hf && (nh == 1 || dout_w * nh != hf)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int err = zero_rows({out}, hf + nh, n_pad, zero_from, st);
  if (err != 0 || n_warps <= 0) return err;
  return dispatch(nh, [&](auto vec_tag, auto maxh_tag) {
    return launch_bwd2<decltype(vec_tag)::value, decltype(maxh_tag)::value, T>(
        wtab, x, vl, cols, occ, unit_start, unit_len, unit_node, unit_part, warp_first,
        split_node, split_first, split_count, out, part, n_warps, n_split, hf, nh, slope, log2_g,
        dout_w, st);
  });
}

// The launch limits of pass-1 kernel `k` of a library function (bwd1 or
// bwd2) at H heads: 0 at f32, 2 at bf16 (1 is the pass-2 kernel, which
// the caller handles).
template <template <int, int, class> class Kernel>
int unit_limits(int k, int nh, size_t smem, int* out) {
  const int block = kWarp * kWarpsPerBlock;
  const bool one = nh == 1;
  switch (k) {
    case 0: return one ? Kernel<4, 1, float>::limits(block, smem, out)
                       : Kernel<4, kMaxHeads, float>::limits(block, smem, out);
    case 2: return one ? Kernel<4, 1, bf16>::limits(block, smem, out)
                       : Kernel<4, kMaxHeads, bf16>::limits(block, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int VEC, int MAXH, class T>
struct Bwd1Kernel {
  static int limits(int block, size_t smem, int* out) {
    return launch_limits(attn_bwd1_kernel<VEC, MAXH, T>, block, smem, out);
  }
};
template <int VEC, int MAXH, class T>
struct Bwd2Kernel {
  static int limits(int block, size_t smem, int* out) {
    return launch_limits(attn_bwd2_kernel<VEC, MAXH, T>, block, smem, out);
  }
};

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; the
// layout arrays are ops.graph.BellDev's (flat_cols, flat_vals as slot
// occupancy) and its WorkUnits tables (the fwd layout's for the forward
// and bwd1, the transpose layout's for bwd2; unit_start int64, the
// others int32).  `vec` is 4: fh % 4 == 0 and 16-byte aligned feature
// tables (the wrappers, ops/kernels/attn_bell.py row_pitch, pad a head
// whose fh is not a multiple of 4 to a lane, its columns at h * pitch
// and zeros after them, and pass hf = H * pitch).  Each launches on
// `stream` without synchronising and returns cudaGetLastError() (0 on
// success).

// Each kernel has two entry points: *_f32 (x, vl, vr and dout float) and
// *_bf16 (the same tables bf16, bf16 activations).  Every other table,
// the outputs and the scratch are f32 in both.

// out (n_pad, hf), m, s (n_pad, H); outpos (n_pad, hf) and spos (n_pad, H)
// may both be null (no flash statistics); rows [zero_from, n_pad) of
// each output are set to 0 first (cudaMemsetAsync: the caller allocates
// them uninitialised; zero_from is WorkUnits.n_written clipped to n_pad,
// below which every row is some unit's node, and 0 without units), so
// rows no unit writes are 0; part is f32 scratch of
// n_partials * (2 hf + 3 H) floats, read only when n_split > 0.  Pass 2
// is launched only when a row is split.  warp_first is the fwd layout's
// warp table for g = 2^log2_g lanes across a row (WorkUnits.warps: null
// at log2_g = 5, where warp w takes unit w), n_warps its warp count;
// log2_g must be row_lanes(hf / vec).  The bf16 entry also takes vec = 8
// (fh % 8 == 0, x 16-byte aligned: 16-byte loads of 8 columns).
#define GALA_ATTN_FWD(NAME, T)                                                                  \
  extern "C" int NAME(const void* x, const void* vl, const void* vr, const void* cols,          \
                      const void* occ, const void* unit_start, const void* unit_len,             \
                      const void* unit_node, const void* unit_part, const void* warp_first,      \
                      const void* split_node, const void* split_first, const void* split_count,  \
                      void* out, void* m, void* s, void* outpos, void* spos, void* part,         \
                      int n_warps, int n_split, int n_partials, int n_pad, int zero_from,       \
                      int hf, int nh, float slope, int vec, int log2_g, void* stream) {          \
    return fwd<T>(x, vl, vr, cols, occ, unit_start, unit_len, unit_node, unit_part, warp_first,  \
                  split_node, split_first, split_count, out, m, s, outpos, spos, part, n_warps,  \
                  n_split, n_partials, n_pad, zero_from, hf, nh, slope, vec, log2_g, stream);    \
  }
GALA_ATTN_FWD(gala_attn_fwd_f32, float)
GALA_ATTN_FWD(gala_attn_fwd_bf16, bf16)

// out (n_pad, 3H) = [sds | A | B]; m, s (n_pad, H) the forward's saved
// f32 statistics; the unit, warp and split tables are the fwd layout's
// WorkUnits (warp_first and log2_g as the forward takes them, n_warps the
// table's warps); rows [zero_from, n_pad) of out are set to 0 first, as
// the forward's; part is f32 scratch of n_partials * 3H floats, read only
// when n_split > 0.  Pass 2 is launched only when a row is split.
#define GALA_ATTN_BWD1(NAME, T)                                                                 \
  extern "C" int NAME(const void* x, const void* vl, const void* vr, const void* dout,          \
                      const void* m, const void* s, const void* cols, const void* occ,           \
                      const void* unit_start, const void* unit_len, const void* unit_node,       \
                      const void* unit_part, const void* warp_first, const void* split_node,     \
                      const void* split_first, const void* split_count, void* out, void* part,   \
                      int n_warps, int n_split, int n_pad, int zero_from, int hf, int nh,        \
                      float slope, int vec, int log2_g, void* stream) {                          \
    return bwd1<T>(x, vl, vr, dout, m, s, cols, occ, unit_start, unit_len, unit_node, unit_part, \
                   warp_first, split_node, split_first, split_count, out, part, n_warps,         \
                   n_split, n_pad, zero_from, hf, nh, slope, vec, log2_g, stream);              \
  }
GALA_ATTN_BWD1(gala_attn_bwd1_f32, float)
GALA_ATTN_BWD1(gala_attn_bwd1_bf16, bf16)

// wtab (n_pad, dout_w + 4H) = [dout | vr | m | s | sds], f32 at either type
// (gala_tpu's w_tab), its dout block hf wide (each head's own) or, at H > 1,
// hf / H (one block every head takes: the gradient of a mean over the
// heads); out (c_pad, hf + H), rows [zero_from, c_pad) set to
// 0 first (c_pad is n_pad here); the unit, warp and split tables are the
// transpose layout's WorkUnits (warp_first and log2_g as the forward takes
// them); part is f32 scratch of n_partials * (hf + H) floats, read only
// when n_split > 0.  Pass 2 is launched only when a row is split.
#define GALA_ATTN_BWD2(NAME, T)                                                                 \
  extern "C" int NAME(const void* wtab, const void* x, const void* vl, const void* cols,        \
                      const void* occ, const void* unit_start, const void* unit_len,             \
                      const void* unit_node, const void* unit_part, const void* warp_first,      \
                      const void* split_node, const void* split_first, const void* split_count,  \
                      void* out, void* part, int n_warps, int n_split, int n_pad, int zero_from, \
                      int hf, int nh, float slope, int vec, int log2_g, int dout_w,              \
                      void* stream) {                                                            \
    return bwd2<T>(wtab, x, vl, cols, occ, unit_start, unit_len, unit_node, unit_part,          \
                   warp_first, split_node, split_first, split_count, out, part, n_warps,         \
                   n_split, n_pad, zero_from, hf, nh, slope, vec, log2_g, dout_w, stream);      \
  }
GALA_ATTN_BWD2(gala_attn_bwd2_f32, float)
GALA_ATTN_BWD2(gala_attn_bwd2_bf16, bf16)

// Launch limits of the forward's kernels at H heads (the instantiation
// that H runs), four ints in `out`: registers per thread, static and
// dynamic shared memory per block, resident blocks per SM.  Kernel k: 0
// pass 1 (float4), 1 pass 2, 2 pass 1 at bf16 (8-byte loads of 4
// columns), 3 pass 1 at bf16 (16-byte loads of 8 columns).  Returns the
// CUDA error, 0 on success.
extern "C" int gala_attn_fwd_limits(int k, int nh, int* out) {
  if (nh < 1 || nh > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  const int block = kWarp * kWarpsPerBlock;
  const size_t smem = unit_warp_smem(nh) * kWarpsPerBlock;
  const bool one = nh == 1;
  switch (k) {
    case 0: return one ? launch_limits(attn_fwd_kernel<4, 1, float>, block, smem, out)
                       : launch_limits(attn_fwd_kernel<4, kMaxHeads, float>, block, smem, out);
    case 1: return launch_limits(attn_fwd_merge_kernel, kMergeThreads, 0, out);
    case 2: return one ? launch_limits(attn_fwd_kernel<4, 1, bf16>, block, smem, out)
                       : launch_limits(attn_fwd_kernel<4, kMaxHeads, bf16>, block, smem, out);
    case 3: return one ? launch_limits(attn_fwd_kernel<8, 1, bf16>, block, smem, out)
                       : launch_limits(attn_fwd_kernel<8, kMaxHeads, bf16>, block, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch limits of bwd2's kernels at H heads, as gala_attn_fwd_limits.
extern "C" int gala_attn_bwd2_limits(int k, int nh, int* out) {
  if (nh < 1 || nh > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 1) return launch_limits(attn_merge_sum_kernel, kMergeThreads, 0, out);
  return unit_limits<Bwd2Kernel>(k, nh, unit_warp_smem(nh) * kWarpsPerBlock, out);
}

// Launch limits of bwd1's kernels at H heads, as gala_attn_fwd_limits.
extern "C" int gala_attn_bwd1_limits(int k, int nh, int* out) {
  if (nh < 1 || nh > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 1) return launch_limits(attn_merge_sum_kernel, kMergeThreads, 0, out);
  return unit_limits<Bwd1Kernel>(k, nh, unit_warp_smem(nh) * kWarpsPerBlock, out);
}
