// Per-edge dot products (SDDMM) for NVIDIA Hopper (sm_90a): the gradient
// of learned edge values in every spmm_ev backward of the port.
//
// Replaces: gala_tpu/ops/pallas/sddmm.py::sddmm_planned (kernel `_kernel`),
// which computes dvals[e] = <a[dst[e]], b[src[e]]> over chunks of edges
// whose rows it stages in VMEM by block DMA and resolves with one-hot MXU
// matmuls.  None of that carries over.  This kernel names its operands
// in the order of the caller, gala_tpu.ops.spmm.sddmm_edges(src, dst, a, b):
//     out[e] = sum_f a[src[e], f] * b[dst[e], f]          (f32)
// over the edge list in forward (dst-sorted) order.  At bf16 (bf16
// activations) a, b and out are bf16: the products and their sum are f32
// and each edge's dot is rounded once, where it is stored; gala_tpu's
// sddmm_edges returns the operands' dtype too.
//
// What bounds it on the H100: bytes, most of them gathered from L2.
// Each edge gathers one row of a at a random source (4*F bytes, 2*F at
// bf16), one row of b at its destination, 8 bytes of indices, and writes
// 4 bytes (2 at bf16); 2*F flops.  On the Arxiv stand-in (2.1M edges, F
// = 32 and 40) the (169k, F) tables fit in the 50 MB L2, so the bound
// counts them once from HBM (3.35 TB/s), but the kernel gathers a row of
// a per edge: at F = 32 f32 2.1M x 128 B = 269 MB a call, ~4.9 TB/s of
// random L2 lines at 0.055 ms (H100 80GB HBM3, 700 W; PERF.md).  At f32 little room is left; bf16 halves those bytes, and
// what spends them is the load instructions and L2 requests a row takes.
//
// Design: the work is split by EDGES, not by destination rows, so a
// hub's thousands of edges spread over many warps: no serial tail.
//   - A warp takes a run of 32 * kEdgesPerLane = 128 consecutive edges.
//     Lane l loads the (src, dst) of edges 4l .. 4l + 3 of the run with
//     one 16-byte load each (coalesced across the warp), so no lane waits
//     on an index load before its row loads.
//   - 16-byte lanes at both types: a lane reads VEC-element vectors of a
//     row, VEC = 4 at f32 and 8 at bf16 (16-byte loads) where F and both
//     tables allow it (ops.kernels.bell_spmm.vector_width), 4 at bf16 (8
//     bytes) where only 4 divide F, else 1.  A bf16 row of F = 32 takes 4
//     lanes, not the 8 of 8-byte loads: half the load instructions and
//     L2 requests for its 64 bytes.  A lane keeps the vectors as loaded
//     (`Packed`, at most 4 registers) and widens them where it multiplies,
//     so four rows in flight cost the same registers at both types, and
//     4 blocks of 8 warps fit an SM (64 registers, no spill).  Left to
//     its own choice the compiler takes 80 registers at f32 (3 blocks),
//     19-20% slower; 3 blocks were 12-19% slower at f32 and at bf16 F =
//     32 (H100 80GB HBM3, 700 W; PERF.md).
//   - A group of gs = min(F / VEC, 32) lanes takes one edge at a time,
//     not rounded to a power of two, and 32 / gs groups share the warp:
//     at F = 40 (10 float4s, 5 bf16 vectors of 8) three or six edges'
//     groups use 30 lanes, where power-of-two groups of 16 or 8 would
//     idle 6 of every 16 or 3 of every 8.  Wider rows (F / VEC > 32) take
//     rounds of 32 vectors.
//   - Group k takes the 4-edge batches of holder lanes k, k + ng, ...,
//     so at each step the warp's groups work on neighbouring batches,
//     which mostly share their destination.  A group keeps b[dst] while
//     dst repeats and reloads it where dst changes.  Giving each group a
//     contiguous stretch of the run instead, so that it reloads b only
//     once per destination, was 10-14% slower at f32 and at bf16 F = 32
//     (PERF.md): the groups' loads of one b row at one step likely meet
//     in L1, where a stretch's reloads do not.
//   - A group takes the indices of its batch's four edges by shuffle and
//     loads the four rows of a before it reduces any of them: four gathers
//     in flight per lane.
//   - The group's lanes are summed by a shuffle tree to the group's first
//     lane, in a fixed order, which stores the batch's four dots:
//     deterministic, no atomics.
//
// Not done yet (later work, see ROADMAP): no shared-memory staging of a's
// rows (the (169k, F) tables sit in L2 at the path's widths).

#include "unit_gather.cuh"  // kWarp, kWarpsPerBlock, kFullMask, bf16, bf16_bits, store_vec

namespace {

using namespace gala;

constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kEdgesPerLane = 4;  // consecutive edges a lane holds the indices of
constexpr int kRun = kWarp * kEdgesPerLane;  // edges per warp
// resident blocks per SM asked of the compiler (__launch_bounds__): 4
// blocks of 8 warps, so at most 64 registers
constexpr int kSddmmBlocks = 4;

// The edge list's run of one warp: lane l holds the (src, dst) of its
// kEdgesPerLane (a multiple of 4) consecutive edges, 16-byte loads of
// four where the run is whole and aligned; an edge past n_edges holds
// index 0 and is never used.
__device__ __forceinline__ void load_indices(const int32_t* __restrict__ src,
                                             const int32_t* __restrict__ dst, long long e0,
                                             long long n_edges, int (&s)[kEdgesPerLane],
                                             int (&d)[kEdgesPerLane]) {
  const bool whole = e0 + kEdgesPerLane <= n_edges &&
                     reinterpret_cast<uintptr_t>(src + e0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst + e0) % 16 == 0;
  if (whole) {
#pragma unroll
    for (int q = 0; q < kEdgesPerLane; q += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(src + e0 + q));
      const int4 b = __ldg(reinterpret_cast<const int4*>(dst + e0 + q));
      s[q] = a.x, s[q + 1] = a.y, s[q + 2] = a.z, s[q + 3] = a.w;
      d[q] = b.x, d[q + 1] = b.y, d[q + 2] = b.z, d[q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kEdgesPerLane; ++u) {
      const bool in = e0 + u < n_edges;
      s[u] = in ? __ldg(src + e0 + u) : 0;
      d[u] = in ? __ldg(dst + e0 + u) : 0;
    }
  }
}

// A lane's VEC elements of one row as loaded (at most 16 bytes, 4
// registers), widened to f32 where the product reads them: four rows in
// flight take 16 registers at bf16 too, not the 32 of widened values.
template <int VEC, class T>
struct Packed {
  static constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  uint32_t w[kBytes >= 4 ? kBytes / 4 : 1];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kBytes == 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (kBytes == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x, w[1] = t.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {  // one bf16: its bits in the high half, as an f32
      w[0] = static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16;
    }
  }
  // element i as f32 (exact); i is a constant once the loops unroll
  __device__ __forceinline__ float at(int i) const {
    if constexpr (std::is_same_v<T, float> || VEC == 1) {
      return __uint_as_float(w[i]);
    } else {
      return i % 2 == 0 ? bf16_bits(w[i / 2]) : __uint_as_float(w[i / 2] & 0xffff0000u);
    }
  }
};

// One warp per run of kRun edges; gs lanes per group, ng = 32 / gs
// groups.  Group k takes the 4-edge batches of holder lanes k, k + ng,
// k + 2 ng, ..., one a step; in a batch, lane `sub` of the group reads
// vectors sub, sub + gs, ... of each edge's rows.
template <int VEC, class T>
__global__ void __launch_bounds__(kThreads, kSddmmBlocks)
sddmm_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
             T* __restrict__ out, long long n_edges, int f, int gs) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long first = warp * kRun;
  if (first >= n_edges) return;  // the same for every lane of the warp
  const int lane = threadIdx.x & (kWarp - 1);
  const int fv = f / VEC;
  const int ng = kWarp / gs;        // groups in the warp
  const int grp = lane / gs;        // ng for the lanes past the last group
  const int sub = lane - grp * gs;
  const bool in_group = grp < ng;
  const bool one_round = fv <= gs;  // each lane reads at most one vector of a row
  int top = 0;  // the largest power of two below gs: the reduction's first step
  for (int t = 1; t < gs; t <<= 1) top = t;

  int hs[kEdgesPerLane], hd[kEdgesPerLane];
  load_indices(src, dst, first + static_cast<long long>(lane) * kEdgesPerLane, n_edges, hs, hd);

  int d_cur = -1;  // the destination whose b vector the lane holds
  Packed<VEC, T> bv;
  const int n_batches = (kWarp + ng - 1) / ng;
  for (int k = 0; k < n_batches; ++k) {
    const int holder = grp + k * ng;  // >= 32 for a group with no batch left
    int s[kEdgesPerLane], d[kEdgesPerLane];
#pragma unroll
    for (int u = 0; u < kEdgesPerLane; ++u) {
      s[u] = __shfl_sync(kFullMask, hs[u], holder & (kWarp - 1));
      d[u] = __shfl_sync(kFullMask, hd[u], holder & (kWarp - 1));
    }
    const long long e0 = first + static_cast<long long>(holder) * kEdgesPerLane;
    const bool live = in_group && holder < kWarp;
    float acc[kEdgesPerLane];
#pragma unroll
    for (int u = 0; u < kEdgesPerLane; ++u) acc[u] = 0.f;
    if (live) {
      for (int j = sub; j < fv; j += gs) {
        if (!one_round) d_cur = -1;  // bv holds another vector of the row
        Packed<VEC, T> av[kEdgesPerLane];
#pragma unroll
        for (int u = 0; u < kEdgesPerLane; ++u) {
          if (e0 + u < n_edges) av[u].load(a + static_cast<size_t>(s[u]) * f + j * VEC);
        }
#pragma unroll
        for (int u = 0; u < kEdgesPerLane; ++u) {
          if (e0 + u < n_edges) {
            if (d[u] != d_cur) {
              bv.load(b + static_cast<size_t>(d[u]) * f + j * VEC);
              d_cur = d[u];
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[u] = fmaf(av[u].at(i), bv.at(i), acc[u]);
          }
        }
      }
    }
    // sum the group's lanes into its lane 0: lane sub adds lane sub + off
    // while that is in the group (gs need not be a power of two)
    for (int off = top; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kEdgesPerLane; ++u) {
        const float v = __shfl_down_sync(kFullMask, acc[u], off);
        if (sub + off < gs) acc[u] += v;
      }
    }
    if (live && sub == 0) {
      if (e0 + kEdgesPerLane <= n_edges &&
          reinterpret_cast<uintptr_t>(out + e0) % (kEdgesPerLane * sizeof(T)) == 0) {
        store_vec<kEdgesPerLane>(out + e0, acc);
      } else {
#pragma unroll
        for (int u = 0; u < kEdgesPerLane; ++u) {
          if (e0 + u < n_edges) {
            const float v[1] = {acc[u]};
            store_vec<1>(out + e0 + u, v);
          }
        }
      }
    }
  }
}

template <class T>
int run(const void* a, const void* b, const void* src, const void* dst, void* out,
        long long n_edges, int f, int vec, void* stream) {
  if (n_edges <= 0 || f <= 0) return 0;
  const bool wide = std::is_same_v<T, bf16> && vec == 8;
  if ((vec != 1 && vec != 4 && !wide) || f % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fv = f / vec;
  const int gs = fv < kWarp ? fv : kWarp;
  const long long warps = (n_edges + kRun - 1) / kRun;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const int32_t* s = static_cast<const int32_t*>(src);
  const int32_t* d = static_cast<const int32_t*>(dst);
  T* o = static_cast<T*>(out);
  if constexpr (std::is_same_v<T, bf16>) {
    if (vec == 8) {
      sddmm_kernel<8, T><<<grid, kThreads, 0, st>>>(at, bt, s, d, o, n_edges, f, gs);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (vec == 4) {
    sddmm_kernel<4, T><<<grid, kThreads, 0, st>>>(at, bt, s, d, o, n_edges, f, gs);
  } else {
    sddmm_kernel<1, T><<<grid, kThreads, 0, st>>>(at, bt, s, d, o, n_edges, f, gs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  Pointers are device pointers; a is
// (rows_a, f), b (rows_b, f), both row-major; src and dst (n_edges,)
// int32 with every src < rows_a and dst < rows_b (n_edges may pass 2^31);
// out (n_edges,).
// gala_sddmm_f32: a, b and out f32; gala_sddmm_bf16: all three bf16.
// `vec` is the elements a lane loads: 8 at bf16 (f % 8 == 0, a and b
// 16-byte aligned), 4 (f % 4 == 0, a and b aligned to 4 elements) or 1.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int gala_sddmm_f32(const void* a, const void* b, const void* src, const void* dst,
                              void* out, long long n_edges, int f, int vec, void* stream) {
  return run<float>(a, b, src, dst, out, n_edges, f, vec, stream);
}

extern "C" int gala_sddmm_bf16(const void* a, const void* b, const void* src, const void* dst,
                               void* out, long long n_edges, int f, int vec, void* stream) {
  return run<bf16>(a, b, src, dst, out, n_edges, f, vec, stream);
}
