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
// ops.  Here the forward covers a whole layout in one call of two
// launches over the layout's work units (ops/graph.py WorkUnits;
// unit_gather.cuh), as the bell SpMM does:
//   pass 1  one warp per unit of at most 128 slots: the unit's softmax
//           statistics (one max and two sums per head for the whole unit,
//           not per 32-slot chunk), then its weighted gather of x through
//           the shared-memory ring.  A unit that is its whole row writes
//           out, m, s (and out+, s+); a unit of a longer row (a hub: its
//           units are its virtual rows) writes the unnormalised partial
//           (m_u, s_u, s+_u, acc_u, acc+_u), the TPU kernel's
//           normalize=False output.
//   pass 2  one block per split row merges its partials in unit order by
//           gala_tpu's online-softmax rescaling (attention.py:663-695):
//           m = max(m_u, floor), s = sum s_u e^(m_u - m), the same for
//           acc, s+ and acc+; s = 1 where the sum is 0; out = acc / s.
// The backward passes keep one warp per descriptor row; a hub is one row
// that its warp walks whole (their split is later work, see ROADMAP).
// No atomics: every sum is taken in a fixed order, so results are
// deterministic.
//
// What bounds them on the H100: bytes.  Per real slot the forward reads
// 8 bytes of (col, occupancy), H scores of vl and one hf-wide row of x;
// bwd2 reads one (hf + 4H)-wide row [dout | vr | m | s | sds] of the
// destination.  There are a few flops per gathered float (an exp per
// slot and head), and no tile is reused, so tensor cores have no role.
// The forward's design: per-slot scalar work lane-per-slot (a unit's 128
// slots are 4 per lane), then the weighted row reduce with lanes across
// the features, gathering through the ring of 16-byte cp.async copies of
// unit_gather.cuh (float4 where fh % 4 == 0 and the tables are 16-byte
// aligned; plain loads with 32 / g slots in flight otherwise); slot
// columns and probabilities pass between the phases through shared
// memory.  The forward is instantiated for one head and for up to 8, so
// the one-head GAT path keeps 32 registers and 8 blocks per SM.  The
// backward kernels gather with plain loads, 32 slots a chunk.
//
// Not done yet (later work, see ROADMAP): the backward passes' hub rows
// are one warp each (bwd2 is the next to take the work units); whether
// plain loads beat the ring here (PERF.md, open questions); f32 only.
//
// Masked slots (occupancy 0: padding and the phantom column) are skipped
// without reading their rows.  Output rows that no unit or row writes
// (padding) are left as the caller allocated them (zeros).

#include <math.h>

#include "unit_gather.cuh"

namespace {

using namespace gala;

constexpr int kMaxHeads = 8;
constexpr int kPer = kUnitSlots / kWarp;  // a unit's slots per lane in the scalar phase
constexpr int kMergeThreads = 64;
constexpr float kNeg = -1e30f;    // masked score (gala_tpu's _NEG)
constexpr float kFloor = -5e29f;  // floor of a row's max, _NEG / 2

__device__ __forceinline__ float lrelu(float z, float slope) { return z > 0.f ? z : slope * z; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// a[h] for a head index known only at run time, without spilling the
// register array to local memory
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int h) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = (i == h) ? a[i] : v;
  return v;
}

// <a[0:n], b[0:n]>, n a multiple of VEC
template <int VEC>
__device__ __forceinline__ float dot(const float* __restrict__ a, const float* __restrict__ b,
                                     int n) {
  float acc = 0.f;
  for (int f = 0; f < n; f += VEC) {
    float u[VEC], w[VEC];
    load_vec<VEC>(a + f, u);
    load_vec<VEC>(b + f, w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(u[i], w[i], acc);
  }
  return acc;
}

// The forward's dynamic shared memory per warp: the ring and the unit's
// columns, then H rows of kUnitSlots probabilities, each stored with the
// sign of its zpre (+p where zpre > 0, -p elsewhere: the flash
// statistics' mask rides in the sign bit).
__host__ __device__ constexpr size_t fwd_warp_smem(int nh) {
  return sizeof(RingSmem) + static_cast<size_t>(nh) * kUnitSlots * sizeof(float);
}
static_assert(fwd_warp_smem(kMaxHeads) * kWarpsPerBlock <= kDefaultSmem,
              "the forward would need cudaFuncSetAttribute");

// Forward pass 1: one warp per unit.  With outpos != null the flash
// statistics out+ = sum_{zpre>0} p x and s+ = sum_{zpre>0} p are taken
// too.  The partial tables of split rows (unnormalised, p = e^(z - m_u)):
// pacc, paccp (n_partials, hf); pm, ps, psp (n_partials, H).  MAXH >= H
// bounds the per-head register arrays (1 for the GAT path's one head).
template <int VEC, int MAXH>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocks)
attn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ vl,
                const float* __restrict__ vr, const int32_t* __restrict__ cols,
                const float* __restrict__ occ, const int32_t* __restrict__ unit_start,
                const int32_t* __restrict__ unit_len, const int32_t* __restrict__ unit_node,
                const int32_t* __restrict__ unit_part, float* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ s_out, float* __restrict__ outpos,
                float* __restrict__ spos_out, float* __restrict__ pacc, float* __restrict__ paccp,
                float* __restrict__ pm, float* __restrict__ ps, float* __restrict__ psp,
                int n_units, int hf, int nh, float slope, int log2_g) {
  extern __shared__ float4 smem[];
  const int w = threadIdx.x / kWarp;
  const int unit = blockIdx.x * kWarpsPerBlock + w;
  if (unit >= n_units) return;  // the same for every lane of the warp
  char* base = reinterpret_cast<char*>(smem) + w * fwd_warp_smem(nh);
  RingSmem& sm = *reinterpret_cast<RingSmem*>(base);
  float* sh_p = reinterpret_cast<float*>(base + sizeof(RingSmem));  // [H][kUnitSlots]

  const bool flash = outpos != nullptr;
  const int fh = hf / nh;
  const Lanes ln(log2_g, hf, fh, VEC);
  const int node = unit_node[unit];
  const int start = unit_start[unit];
  const int len = unit_len[unit];

  // scalar phase: lane t scores slots t, t + 32, t + 64 and t + 96 of the
  // unit for every head; one max and two sums per head for the unit
  float vr_n[MAXH], m_u[MAXH], s_u[MAXH], sp_u[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    vr_n[h] = h < nh ? __ldg(vr + static_cast<size_t>(node) * nh + h) : 0.f;
    m_u[h] = kFloor;
    s_u[h] = sp_u[h] = 0.f;
  }
  float zpre[kPer][MAXH];
  bool real[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = ln.lane + i * kWarp;
    int c = 0;
    real[i] = false;
    if (t < len) {
      c = __ldg(cols + start + t);
      real[i] = __ldg(occ + start + t) != 0.f;
      sm.col[t] = c;
    }
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      zpre[i][h] = 0.f;
      if (h < nh && real[i]) {
        zpre[i][h] = __ldg(vl + static_cast<size_t>(c) * nh + h) + vr_n[h];
        m_u[h] = fmaxf(m_u[h], lrelu(zpre[i][h], slope));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < nh) {
      m_u[h] = warp_max(m_u[h]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int t = ln.lane + i * kWarp;
        const float p = real[i] ? expf(lrelu(zpre[i][h], slope) - m_u[h]) : 0.f;
        const bool pos = zpre[i][h] > 0.f;
        s_u[h] += p;
        if (pos) sp_u[h] += p;
        if (t < len) sh_p[h * kUnitSlots + t] = pos ? p : -p;
      }
      s_u[h] = warp_sum(s_u[h]);
      if (flash) sp_u[h] = warp_sum(sp_u[h]);
    }
  }
  __syncwarp();

  // reduce phase: lanes across features, gathering through the ring; a
  // slot of weight 0 (masked, or underflowed) is not read
  float acc[VEC], accp[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = accp[i] = 0.f;
  const float* ph = sh_p + ln.hd * kUnitSlots;
  gather_unit<VEC>(sm, len, x, hf, ln, [&](int j) { return ph[j] != 0.f; },
                   [&](int j, const float (&v)[VEC]) {
                     const float pv = ph[j];
                     const float p = fabsf(pv);
#pragma unroll
                     for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, v[i], acc[i]);
                     if (flash && pv > 0.f) {
#pragma unroll
                       for (int i = 0; i < VEC; ++i) accp[i] = fmaf(pv, v[i], accp[i]);
                     }
                   });

  // sum the slot groups: lanes that share (lane % g) hold one vector
  for (int off = kWarp / 2; off >= ln.g; off >>= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] += __shfl_xor_sync(kFullMask, acc[i], off);
      if (flash) accp[i] += __shfl_xor_sync(kFullMask, accp[i], off);
    }
  }

  const int p = unit_part[unit];
  const size_t col = static_cast<size_t>(ln.vcol) * VEC;
  if (p >= 0) {  // a partial of a split row, unnormalised
    if (ln.sub == 0 && ln.active) {
      const size_t o = static_cast<size_t>(p) * hf + col;
      store_vec<VEC>(pacc + o, acc);
      if (flash) store_vec<VEC>(paccp + o, accp);
    }
    if (blockIdx.y == 0 && ln.lane < nh) {
      const size_t o = static_cast<size_t>(p) * nh + ln.lane;
      pm[o] = pick(m_u, ln.lane);
      ps[o] = pick(s_u, ln.lane);
      if (flash) psp[o] = pick(sp_u, ln.lane);
    }
    return;
  }
  float s_fin[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) s_fin[h] = s_u[h] > 0.f ? s_u[h] : 1.f;
  if (ln.sub == 0 && ln.active) {
    const float s = pick(s_fin, ln.hd);
    const size_t o = static_cast<size_t>(node) * hf + col;
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = acc[i] / s;
    store_vec<VEC>(out + o, v);
    if (flash) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = accp[i] / s;
      store_vec<VEC>(outpos + o, v);
    }
  }
  if (blockIdx.y == 0 && ln.lane < nh) {
    const size_t o = static_cast<size_t>(node) * nh + ln.lane;
    m_out[o] = pick(m_u, ln.lane);
    s_out[o] = pick(s_fin, ln.lane);
    if (flash) spos_out[o] = pick(sp_u, ln.lane) / pick(s_fin, ln.lane);
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

// Backward pass 1: one warp per forward row, lane per slot.  p is
// recomputed from the node's saved (m, s); dp = <dout[r], x[c]> per
// head; sds = sum p dp, A = sum p dp lrelu', B = sum p lrelu'.
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
attn_bwd1_kernel(const float* __restrict__ x, const float* __restrict__ vl,
                 const float* __restrict__ vr, const float* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ s,
                 const int32_t* __restrict__ cols, const float* __restrict__ occ,
                 const int32_t* __restrict__ row_start, const int32_t* __restrict__ row_len,
                 const int32_t* __restrict__ row_node, float* __restrict__ sds_out,
                 float* __restrict__ a_out, float* __restrict__ b_out, int n_rows, int hf, int nh,
                 float slope) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;

  const int fh = hf / nh;
  const int node = row_node[row];
  const int start = row_start[row];
  const int len = row_len[row];
  const float* dout_r = dout + static_cast<size_t>(node) * hf;

  float vr_n[kMaxHeads], m_n[kMaxHeads], s_n[kMaxHeads];
  float sds[kMaxHeads], a[kMaxHeads], b[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    const size_t o = static_cast<size_t>(node) * nh + h;
    vr_n[h] = h < nh ? __ldg(vr + o) : 0.f;
    m_n[h] = h < nh ? __ldg(m + o) : 0.f;
    s_n[h] = h < nh ? __ldg(s + o) : 1.f;
    sds[h] = a[h] = b[h] = 0.f;
  }

  for (int t = lane; t < len; t += kWarp) {
    if (__ldg(occ + start + t) == 0.f) continue;
    const int c = __ldg(cols + start + t);
    const float* x_c = x + static_cast<size_t>(c) * hf;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < nh) {
        const float zpre = __ldg(vl + static_cast<size_t>(c) * nh + h) + vr_n[h];
        const float p = expf(lrelu(zpre, slope) - m_n[h]) / s_n[h];
        const float dp = dot<VEC>(dout_r + h * fh, x_c + h * fh, fh);
        const float lr = zpre > 0.f ? 1.f : slope;
        sds[h] = fmaf(p, dp, sds[h]);
        a[h] = fmaf(p * dp, lr, a[h]);
        b[h] = fmaf(p, lr, b[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < nh) {
      const float vs = warp_sum(sds[h]), va = warp_sum(a[h]), vb = warp_sum(b[h]);
      if (lane == 0) {
        const size_t o = static_cast<size_t>(node) * nh + h;
        sds_out[o] = vs;
        a_out[o] = va;
        b_out[o] = vb;
      }
    }
  }
}

// Backward pass 2: one warp per transpose row (source node c).  Lane t
// reads destination r's row [dout | vr | m | s | sds] of `wtab`,
// recomputes p, forms dp = <dout[r], x[c]>, ds = p (dp - sds[r]) and
// dz = ds lrelu', and keeps its share of dvl[c] = sum dz; then lanes
// across features sum dx[c] = sum p dout[r].  Output row c of `out` is
// [dx | dvl], hf + H wide.
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
attn_bwd2_kernel(const float* __restrict__ wtab, const float* __restrict__ x,
                 const float* __restrict__ vl, const int32_t* __restrict__ cols,
                 const float* __restrict__ occ, const int32_t* __restrict__ row_start,
                 const int32_t* __restrict__ row_len, const int32_t* __restrict__ row_node,
                 float* __restrict__ out, int n_rows, int hf, int nh, float slope, int log2_g) {
  __shared__ int sh_col[kWarpsPerBlock][kWarp];
  __shared__ float sh_p[kWarpsPerBlock][kMaxHeads][kWarp];
  const int w = threadIdx.x / kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + w;
  if (row >= n_rows) return;

  const int fh = hf / nh;
  const int wt = hf + 4 * nh;
  const Lanes ln(log2_g, hf, fh, VEC);
  const int hd = ln.hd;
  const int node = row_node[row];
  const int start = row_start[row];
  const int len = row_len[row];
  const float* x_c = x + static_cast<size_t>(node) * hf;

  float vl_c[kMaxHeads], dvl[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    vl_c[h] = h < nh ? __ldg(vl + static_cast<size_t>(node) * nh + h) : 0.f;
    dvl[h] = 0.f;
  }
  float dx[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) dx[i] = 0.f;

  for (int base = 0; base < len; base += kWarp) {
    const int t = base + ln.lane;
    int r = 0;
    bool real = false;
    if (t < len) {
      r = __ldg(cols + start + t);
      real = __ldg(occ + start + t) != 0.f;
    }
    const float* wr = wtab + static_cast<size_t>(r) * wt;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < nh) {
        float p = 0.f;
        if (real) {
          const float zpre = vl_c[h] + __ldg(wr + hf + h);
          p = expf(lrelu(zpre, slope) - __ldg(wr + hf + nh + h)) / __ldg(wr + hf + 2 * nh + h);
          const float dp = dot<VEC>(wr + h * fh, x_c + h * fh, fh);
          const float ds = p * (dp - __ldg(wr + hf + 3 * nh + h));
          dvl[h] = fmaf(ds, zpre > 0.f ? 1.f : slope, dvl[h]);
        }
        sh_p[w][h][ln.lane] = p;
      }
    }
    sh_col[w][ln.lane] = r;
    __syncwarp();

    const int n = min(kWarp, len - base);
    if (ln.active) {
      for (int j = ln.sub; j < n; j += ln.groups) {
        const float p = sh_p[w][hd][j];
        if (p == 0.f) continue;
        float v[VEC];
        load_vec<VEC>(wtab + static_cast<size_t>(sh_col[w][j]) * wt + ln.vcol * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dx[i] = fmaf(p, v[i], dx[i]);
      }
    }
    __syncwarp();
  }

  for (int off = kWarp / 2; off >= ln.g; off >>= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dx[i] += __shfl_xor_sync(kFullMask, dx[i], off);
  }
  const int ow = hf + nh;
  if (ln.sub == 0 && ln.active) {
    float* o = out + static_cast<size_t>(node) * ow + static_cast<size_t>(ln.vcol) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = dx[i];  // rows of hf + H floats: no vector stores
  }
  if (blockIdx.y == 0) {
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < nh) {
        const float v = warp_sum(dvl[h]);
        if (ln.lane == 0) out[static_cast<size_t>(node) * ow + hf + h] = v;
      }
    }
  }
}

bool bad_shape(int hf, int nh, int vec) {
  return nh < 1 || nh > kMaxHeads || hf <= 0 || hf % nh != 0 || (vec != 1 && vec != 4) ||
         (vec == 4 && (hf / nh) % 4 != 0);
}

template <int VEC, int MAXH>
int launch_fwd(const void* x, const void* vl, const void* vr, const void* cols, const void* occ,
               const void* unit_start, const void* unit_len, const void* unit_node,
               const void* unit_part, const void* split_node, const void* split_first,
               const void* split_count, void* out, void* m, void* s, void* outpos, void* spos,
               void* part, int n_units, int n_split, int n_partials, int hf, int nh,
               float slope, cudaStream_t st) {
  const size_t smem = fwd_warp_smem(nh) * kWarpsPerBlock;
  // the partial tables, one scratch block: acc, acc+ (P, hf); m, s, s+ (P, H)
  float* pacc = static_cast<float*>(part);
  const size_t ph = static_cast<size_t>(n_partials) * hf, pn = static_cast<size_t>(n_partials) * nh;
  float* paccp = pacc + ph;
  float* pm = paccp + ph;
  float* ps = pm + pn;
  float* psp = ps + pn;
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  int log2_g;
  dim3 grid;
  reduce_grid(n_units, hf, VEC, &log2_g, &grid);
  attn_fwd_kernel<VEC, MAXH><<<grid, kWarp * kWarpsPerBlock, smem, st>>>(
      f32(x), f32(vl), f32(vr), i32(cols), f32(occ), i32(unit_start), i32(unit_len),
      i32(unit_node), i32(unit_part), static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(outpos), static_cast<float*>(spos), pacc, paccp,
      pm, ps, psp, n_units, hf, nh, slope, log2_g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 0) return err;
  attn_fwd_merge_kernel<<<n_split, kMergeThreads, 0, st>>>(
      pacc, paccp, pm, ps, psp, i32(split_node), i32(split_first), i32(split_count),
      static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(s),
      static_cast<float*>(outpos), static_cast<float*>(spos), hf, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; the
// layout arrays are ops.graph.BellDev's (flat_cols, flat_vals as slot
// occupancy) and its WorkUnits tables (units for the forward, row
// descriptors for the backward passes).  `vec` is 4 (fh % 4 == 0 and
// 16-byte aligned feature tables) or 1.  Each launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).

// out (n_pad, hf), m, s (n_pad, H); outpos (n_pad, hf) and spos (n_pad, H)
// may both be null (no flash statistics); part is f32 scratch of
// n_partials * (2 hf + 3 H) floats, read only when n_split > 0.  Pass 2
// is launched only when a row is split.
extern "C" int gala_attn_fwd_f32(const void* x, const void* vl, const void* vr, const void* cols,
                                 const void* occ, const void* unit_start, const void* unit_len,
                                 const void* unit_node, const void* unit_part,
                                 const void* split_node, const void* split_first,
                                 const void* split_count, void* out, void* m, void* s,
                                 void* outpos, void* spos, void* part, int n_units, int n_split,
                                 int n_partials, int hf, int nh, float slope, int vec,
                                 void* stream) {
  if (n_units <= 0) return 0;
  if (bad_shape(hf, nh, vec) || ((outpos == nullptr) != (spos == nullptr)) ||
      (n_split > 0 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&](auto vec_tag, auto maxh_tag) {
    return launch_fwd<decltype(vec_tag)::value, decltype(maxh_tag)::value>(
        x, vl, vr, cols, occ, unit_start, unit_len, unit_node, unit_part, split_node,
        split_first, split_count, out, m, s, outpos, spos, part, n_units, n_split, n_partials,
        hf, nh, slope, static_cast<cudaStream_t>(stream));
  };
  using One = std::integral_constant<int, 1>;
  using Four = std::integral_constant<int, 4>;
  using Max = std::integral_constant<int, kMaxHeads>;
  if (vec == 4) return nh == 1 ? run(Four{}, One{}) : run(Four{}, Max{});
  return nh == 1 ? run(One{}, One{}) : run(One{}, Max{});
}

// sds, a, b (n_pad, H); m, s the forward's saved statistics.
extern "C" int gala_attn_bwd1_f32(const void* x, const void* vl, const void* vr, const void* dout,
                                  const void* m, const void* s, const void* cols, const void* occ,
                                  const void* row_start, const void* row_len,
                                  const void* row_node, void* sds, void* a, void* b, int n_rows,
                                  int hf, int nh, float slope, int vec, void* stream) {
  if (n_rows <= 0) return 0;
  if (bad_shape(hf, nh, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GALA_ATTN_BWD1(V)                                                                      \
  attn_bwd1_kernel<V><<<grid, block, 0, st>>>(                                                 \
      static_cast<const float*>(x), static_cast<const float*>(vl),                             \
      static_cast<const float*>(vr), static_cast<const float*>(dout),                          \
      static_cast<const float*>(m), static_cast<const float*>(s),                              \
      static_cast<const int32_t*>(cols), static_cast<const float*>(occ),                       \
      static_cast<const int32_t*>(row_start), static_cast<const int32_t*>(row_len),            \
      static_cast<const int32_t*>(row_node), static_cast<float*>(sds), static_cast<float*>(a), \
      static_cast<float*>(b), n_rows, hf, nh, slope)
  if (vec == 4) {
    GALA_ATTN_BWD1(4);
  } else {
    GALA_ATTN_BWD1(1);
  }
#undef GALA_ATTN_BWD1
  return static_cast<int>(cudaGetLastError());
}

// wtab (n_pad, hf + 4H) = [dout | vr | m | s | sds]; out (c_pad, hf + H).
extern "C" int gala_attn_bwd2_f32(const void* wtab, const void* x, const void* vl,
                                  const void* cols, const void* occ, const void* row_start,
                                  const void* row_len, const void* row_node, void* out,
                                  int n_rows, int hf, int nh, float slope, int vec,
                                  void* stream) {
  if (n_rows <= 0) return 0;
  if (bad_shape(hf, nh, vec)) return static_cast<int>(cudaErrorInvalidValue);
  int log2_g;
  dim3 grid;
  reduce_grid(n_rows, hf, vec, &log2_g, &grid);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GALA_ATTN_BWD2(V)                                                                      \
  attn_bwd2_kernel<V><<<grid, block, 0, st>>>(                                                 \
      static_cast<const float*>(wtab), static_cast<const float*>(x),                           \
      static_cast<const float*>(vl), static_cast<const int32_t*>(cols),                        \
      static_cast<const float*>(occ), static_cast<const int32_t*>(row_start),                  \
      static_cast<const int32_t*>(row_len), static_cast<const int32_t*>(row_node),             \
      static_cast<float*>(out), n_rows, hf, nh, slope, log2_g)
  if (vec == 4) {
    GALA_ATTN_BWD2(4);
  } else {
    GALA_ATTN_BWD2(1);
  }
#undef GALA_ATTN_BWD2
  return static_cast<int>(cudaGetLastError());
}

// Launch limits of the forward's kernels at H heads (the instantiation
// that H runs), four ints in `out`: registers per thread, static and
// dynamic shared memory per block, resident blocks per SM.  Kernel k: 0
// pass 1 (float4), 1 pass 1 (scalar), 2 pass 2.  Returns the CUDA error,
// 0 on success.
extern "C" int gala_attn_fwd_limits(int k, int nh, int* out) {
  if (nh < 1 || nh > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_warp_smem(nh) * kWarpsPerBlock;
  const int block = kWarp * kWarpsPerBlock;
  switch (k) {
    case 0:
      return nh == 1 ? launch_limits(attn_fwd_kernel<4, 1>, block, smem, out)
                     : launch_limits(attn_fwd_kernel<4, kMaxHeads>, block, smem, out);
    case 1:
      return nh == 1 ? launch_limits(attn_fwd_kernel<1, 1>, block, smem, out)
                     : launch_limits(attn_fwd_kernel<1, kMaxHeads>, block, smem, out);
    case 2: return launch_limits(attn_fwd_merge_kernel, kMergeThreads, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
