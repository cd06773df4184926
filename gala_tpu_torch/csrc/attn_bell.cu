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
// ops.  Here ONE launch covers a whole layout, driven by the per-row
// descriptors (row_start, row_len, row_node) of ops.graph.BellDev: a
// hub's virtual rows are contiguous slots, so a hub is one row and its
// softmax max and sum are taken in the row loop (an online softmax over
// one contiguous row replaces the normalize=False partials and the
// segment-op merge).  No atomics: every sum is taken by one warp in a
// fixed order, so results are deterministic.
//
// What bounds them on the H100: bytes.  Per real slot the forward reads
// 8 bytes of (col, occupancy), H scores of vl and one hf-wide row of x;
// bwd2 reads one (hf + 4H)-wide row [dout | vr | m | s | sds] of the
// destination.  There are a few flops per gathered float (an exp per
// slot and head).  The design answers as the bell SpMM kernel does: one
// warp per row; one coalesced load of 32 (col, occupancy) pairs per
// warp; the per-slot scalar work (scores, softmax statistics, dot
// products) lane-per-slot; the weighted row reduce with lanes across the
// features in full 16-byte loads (float4 where fh % 4 == 0) and, for
// narrow rows, 32 / g slot groups in flight, summed by shuffles at the
// end.  Slot columns and probabilities pass from the scalar phase to the
// reduce phase through a 32-slot stage in shared memory per warp.
//
// Not done yet (later work, see ROADMAP): a hub row is one warp, so the
// longest row (6,656 slots on the Arxiv stand-in) is a serial tail, as in
// the bell SpMM kernel; no cp.async or TMA staging; f32 only.
//
// Masked slots (occupancy 0: padding and the phantom column) are skipped
// without reading their rows.  Output rows that no descriptor names
// (padding) are left as the caller allocated them (zeros).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxHeads = 8;
constexpr unsigned kFullMask = 0xffffffffu;
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
__device__ __forceinline__ float pick(const float (&a)[kMaxHeads], int h) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < kMaxHeads; ++i) v = (i == h) ? a[i] : v;
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

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
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

// Lane roles of the reduce phase (as in bell_spmm.cu): g = 2^log2_g lanes
// across the row's hf/VEC vectors, 32/g slot groups; blockIdx.y selects
// which g-vector slice of the row this warp reduces.
// hd is the head of the lane's vector (VEC divides fh, so a vector never
// straddles two heads).
struct Lanes {
  int lane, sub, groups, g, vcol, hd;
  bool active;
  __device__ Lanes(int log2_g, int hf, int fh, int vec) {
    lane = threadIdx.x & (kWarp - 1);
    g = 1 << log2_g;
    groups = kWarp >> log2_g;
    sub = lane >> log2_g;
    vcol = blockIdx.y * g + (lane & (g - 1));
    active = vcol < hf / vec;
    hd = active ? (vcol * vec) / fh : 0;
  }
};

// Forward: one warp per destination row.  Online softmax over the row's
// slots, 32 at a time: the chunk's max per head moves the running max,
// the running sums and the lanes' accumulators are rescaled, then the
// chunk's probabilities weight the gathered x rows.  With outpos != null
// the flash statistics out+ = sum_{zpre>0} p x and s+ = sum_{zpre>0} p
// are accumulated with the same rescaling.
template <int VEC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
attn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ vl,
                const float* __restrict__ vr, const int32_t* __restrict__ cols,
                const float* __restrict__ occ, const int32_t* __restrict__ row_start,
                const int32_t* __restrict__ row_len, const int32_t* __restrict__ row_node,
                float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ s_out,
                float* __restrict__ outpos, float* __restrict__ spos_out, int n_rows, int hf,
                int nh, float slope, int log2_g) {
  __shared__ int sh_col[kWarpsPerBlock][kWarp];
  __shared__ float sh_p[kWarpsPerBlock][kMaxHeads][kWarp];
  __shared__ float sh_pp[kWarpsPerBlock][kMaxHeads][kWarp];
  const int w = threadIdx.x / kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + w;
  if (row >= n_rows) return;  // the same for every lane of the warp

  const bool flash = outpos != nullptr;
  const int fh = hf / nh;
  const Lanes ln(log2_g, hf, fh, VEC);
  const int hd = ln.hd;
  const int node = row_node[row];
  const int start = row_start[row];
  const int len = row_len[row];

  float vr_n[kMaxHeads], m_run[kMaxHeads], s_run[kMaxHeads], sp_run[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    vr_n[h] = h < nh ? __ldg(vr + static_cast<size_t>(node) * nh + h) : 0.f;
    m_run[h] = kFloor;
    s_run[h] = 0.f;
    sp_run[h] = 0.f;
  }
  float acc[VEC], accp[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = accp[i] = 0.f;

  for (int base = 0; base < len; base += kWarp) {
    // scalar phase: lane t scores slot base + t for every head
    const int t = base + ln.lane;
    int c = 0;
    bool real = false;
    if (t < len) {
      c = __ldg(cols + start + t);
      real = __ldg(occ + start + t) != 0.f;
    }
    float scale[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      scale[h] = 1.f;
      if (h < nh) {
        const float zpre = real ? __ldg(vl + static_cast<size_t>(c) * nh + h) + vr_n[h] : 0.f;
        const float z = real ? lrelu(zpre, slope) : kNeg;
        const float m_new = fmaxf(m_run[h], warp_max(z));
        scale[h] = expf(m_run[h] - m_new);
        const float p = real ? expf(z - m_new) : 0.f;
        const float pp = zpre > 0.f ? p : 0.f;
        s_run[h] = fmaf(s_run[h], scale[h], warp_sum(p));
        if (flash) sp_run[h] = fmaf(sp_run[h], scale[h], warp_sum(pp));
        m_run[h] = m_new;
        sh_p[w][h][ln.lane] = p;
        sh_pp[w][h][ln.lane] = pp;
      }
    }
    sh_col[w][ln.lane] = c;
    __syncwarp();

    // reduce phase: lanes across features, 32/g slots in flight
    const float sc = pick(scale, hd);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] *= sc;
      accp[i] *= sc;
    }
    const int n = min(kWarp, len - base);
    if (ln.active) {
      for (int j = ln.sub; j < n; j += ln.groups) {
        const float p = sh_p[w][hd][j];
        if (p == 0.f) continue;  // masked slot (or an underflowed weight)
        float v[VEC];
        load_vec<VEC>(x + static_cast<size_t>(sh_col[w][j]) * hf + ln.vcol * VEC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, v[i], acc[i]);
        if (flash) {
          const float pp = sh_pp[w][hd][j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) accp[i] = fmaf(pp, v[i], accp[i]);
        }
      }
    }
    __syncwarp();  // the stage is rewritten by the next chunk
  }

  // sum the slot groups: lanes that share (lane % g) hold one vector
  for (int off = kWarp / 2; off >= ln.g; off >>= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc[i] += __shfl_xor_sync(kFullMask, acc[i], off);
      if (flash) accp[i] += __shfl_xor_sync(kFullMask, accp[i], off);
    }
  }
  float s_fin[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) s_fin[h] = s_run[h] > 0.f ? s_run[h] : 1.f;

  if (ln.sub == 0 && ln.active) {
    const float s = pick(s_fin, hd);
    const size_t o = static_cast<size_t>(node) * hf + static_cast<size_t>(ln.vcol) * VEC;
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
    m_out[o] = pick(m_run, ln.lane);
    s_out[o] = pick(s_fin, ln.lane);
    if (flash) spos_out[o] = pick(sp_run, ln.lane) / pick(s_fin, ln.lane);
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

// g = lanes across the hf/vec vectors of a row (a power of two, at most
// 32); the grid's y covers the vectors g at a time
void reduce_grid(int n_rows, int hf, int vec, int* log2_g, dim3* grid) {
  const int fv = hf / vec;
  int l = 0;
  while ((1 << l) < fv && l < 5) ++l;
  const int g = 1 << l;
  *log2_g = l;
  *grid = dim3((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock, (fv + g - 1) / g);
}

bool bad_shape(int hf, int nh, int vec) {
  return nh < 1 || nh > kMaxHeads || hf <= 0 || hf % nh != 0 || (vec != 1 && vec != 4) ||
         (vec == 4 && (hf / nh) % 4 != 0);
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; the
// layout arrays are ops.graph.BellDev's (flat_cols, flat_vals as slot
// occupancy, row_start, row_len, row_node).  `vec` is 4 (fh % 4 == 0 and
// 16-byte aligned feature tables) or 1.  Each launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).

// out (n_pad, hf), m, s (n_pad, H); outpos (n_pad, hf) and spos (n_pad, H)
// may both be null (no flash statistics).
extern "C" int gala_attn_fwd_f32(const void* x, const void* vl, const void* vr, const void* cols,
                                 const void* occ, const void* row_start, const void* row_len,
                                 const void* row_node, void* out, void* m, void* s, void* outpos,
                                 void* spos, int n_rows, int hf, int nh, float slope, int vec,
                                 void* stream) {
  if (n_rows <= 0) return 0;
  if (bad_shape(hf, nh, vec) || ((outpos == nullptr) != (spos == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int log2_g;
  dim3 grid;
  reduce_grid(n_rows, hf, vec, &log2_g, &grid);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GALA_ATTN_FWD(V)                                                                       \
  attn_fwd_kernel<V><<<grid, block, 0, st>>>(                                                  \
      static_cast<const float*>(x), static_cast<const float*>(vl),                             \
      static_cast<const float*>(vr), static_cast<const int32_t*>(cols),                        \
      static_cast<const float*>(occ), static_cast<const int32_t*>(row_start),                  \
      static_cast<const int32_t*>(row_len), static_cast<const int32_t*>(row_node),             \
      static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(s),                \
      static_cast<float*>(outpos), static_cast<float*>(spos), n_rows, hf, nh, slope, log2_g)
  if (vec == 4) {
    GALA_ATTN_FWD(4);
  } else {
    GALA_ATTN_FWD(1);
  }
#undef GALA_ATTN_FWD
  return static_cast<int>(cudaGetLastError());
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
