#!/usr/bin/env python3
"""The unit kernels' pass 1 (the SpMM, the attention forward, bwd1 and
bwd2) against the variants they were measured against, on one NVIDIA GPU.

    python3 scripts/unit_variants_torch.py [--runs 7] [--out PATH]
        [--variants NAME ...] [--kernels SUBSTRING ...]

csrc/bell_spmm.cu and csrc/attn_bell.cu ship plain loads and two choices
that trade registers against rows in flight: the rows of a slot group in
flight per step of the gather (kRowsInFlight, kFwdRows, kBwd1Rows,
kBwd2Rows) and the resident blocks per SM each kernel asks of the
compiler (its __launch_bounds__, which caps its registers).  This
script keeps the alternatives, as text substitutions in copies of the
sources under
gala_tpu_torch/_build/var_<name>/ (git-ignored), built in parallel as
lib*_<name>_<hash>.so (nothing of the package selects them; a library
whose sources a variant leaves alone is the shipped build):

    fwd_rows4           the forward with 4 rows in flight at 4-column lanes,
                        2 at 8
    spmm_6x4            the SpMM at 6 blocks per SM (40 registers), 4 rows
                        in flight
    fwd_8blocks         the forward at 8 blocks per SM (32 registers)
    bwd1_8blocks        bwd1's one-head forms at 8 blocks per SM (32
                        registers; the shipped: 6, 40 registers)
    bwd2_8blocks        bwd2's one-head forms at 8 blocks per SM (32
                        registers; the shipped: 6, 40 registers)
    sampled_8blocks     the SpMM's sampled form at 8 blocks per SM (32
                        registers, the unsampled form's; it spills 8-12
                        bytes; the shipped: 6, 40 registers)
    bwd2_scalar_quad    bwd2's one-head form reads a slot's [vr | m | s |
                        sds] by four 4-byte loads, as the multi-head form
                        reads its four blocks (the shipped: one 16-byte
                        load)
    bulk                the SpMM's gather by bulk copies where a warp takes
                        one unit and its lanes cover 128 floats of a row
                        (f32, F a multiple of 4 and at least 128): lane 0
                        keeps RING rows in flight, one cp.async.bulk of the
                        512-byte slice each into a per-warp ring, each
                        stage's completion on its own mbarrier; the lanes
                        sum in slot order.  Other shapes keep plain loads
                        (F = 32 is a control).

It prints ptxas's spills of each variant's pass-1 kernels, checks that
every variant's results are bitwise the shipped build's (the order of
each sum is the same), and times the SpMM at F = 32 and 128 on the GCN's
full bell, the forward (flash statistics on) at hf = 32 and 40 with one
head and hf = 64 with 8, and bwd1 and bwd2 at the same shapes, on the
fused GAT's layouts of the Arxiv stand-in, and the SpMM's sampled form at
F = 32 on the dynamic GCN's full bell (k = 20, one epoch's (ra, rb)), f32 and
bf16: each variant
`runs` times, in turns (one run: 20 calls between two CUDA events, after
a warm-up).  --variants and --kernels (substrings of the case names)
choose a subset.  Prints the medians and the runs' spread, the card's
name and power limit and one JSON line; writes the same JSON to --out
(default results/unit_variants.json, git-ignored).  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("bell_spmm.cu", "attn_bell.cu", "unit_gather.cuh")
SHIPPED_ROWS_FWD = "constexpr int kFwdRows = VEC == 1 ? 4 : VEC == 4 ? 2 : 1;"
SHIPPED_ROWS_SPMM = "constexpr int kRowsInFlight = VEC == 1 ? 4 : VEC == 4 ? 2 : 1;"
SHIPPED_SPMM_BOUNDS = ("__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, "
                       "SAMPLED ? kSampledBlocks : kMinBlocks)\n"
                       "spmm_unit_kernel")
SHIPPED_FWD_BLOCKS = "constexpr int kFwdMinBlocks = 6;"
SHIPPED_BWD1_BLOCKS = "constexpr int kBwd1MinBlocks = 6;"
SHIPPED_BWD2_BLOCKS = "constexpr int kBwd2MinBlocks = 6;"
SHIPPED_SAMPLED_BLOCKS = "constexpr int kSampledBlocks = 6;"
SHIPPED_BWD2_QUAD = ("if constexpr (MAXH == 1) {\n"
                     "        v = __ldg(reinterpret_cast<const float4*>(wr));")
VARIANTS = {
    "shipped": [],
    "fwd_rows4": [("attn_bell.cu", SHIPPED_ROWS_FWD,
                   "constexpr int kFwdRows = VEC == 1 ? 4 : VEC == 4 ? 4 : 2;")],
    "spmm_6x4": [("bell_spmm.cu", SHIPPED_ROWS_SPMM,
                  "constexpr int kRowsInFlight = VEC == 1 ? 4 : VEC == 4 ? 4 : 2;"),
                 ("bell_spmm.cu", SHIPPED_SPMM_BOUNDS,
                  SHIPPED_SPMM_BOUNDS.replace("kMinBlocks", "6"))],
    "fwd_8blocks": [("attn_bell.cu", SHIPPED_FWD_BLOCKS, "constexpr int kFwdMinBlocks = 8;")],
    "bwd1_8blocks": [("attn_bell.cu", SHIPPED_BWD1_BLOCKS, "constexpr int kBwd1MinBlocks = 8;")],
    "bwd2_8blocks": [("attn_bell.cu", SHIPPED_BWD2_BLOCKS, "constexpr int kBwd2MinBlocks = 8;")],
    "sampled_8blocks": [("bell_spmm.cu", SHIPPED_SAMPLED_BLOCKS,
                         "constexpr int kSampledBlocks = 8;")],
    "bwd2_scalar_quad": [("attn_bell.cu", SHIPPED_BWD2_QUAD,
                          SHIPPED_BWD2_QUAD.replace("MAXH == 1", "MAXH < 1"))],
}

RING = 4  # bulk: rows of a unit in flight
# the ring of a warp, after its (col, val) staging: RING stages of one row
# slice (32 float4) and their mbarriers
BULK_SMEM = f"""constexpr int kRing = {RING};
struct WarpSmem {{
  UnitSmem r;
  float val[kUnitSlots];
  float4 row[kRing][kWarp];
  uint64_t bar[kRing];
}};"""

BULK_HELPERS = r"""
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// one row slice into a stage: the stage's barrier expects its bytes
__device__ __forceinline__ void bulk_row(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// the unit's rows through the ring: one warp, one unit, 32 lanes of 4
// floats across a slice of 128 (the slice `slice` of a row of f floats)
template <class Use>
__device__ __forceinline__ void bulk_gather(WarpSmem& sm, const int32_t* col, int len,
                                            const float* __restrict__ x, int f, int slice,
                                            Use use) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c0 = slice * kWarp * 4;
  const uint32_t bytes = static_cast<uint32_t>(min(kWarp * 4, f - c0)) * 4u;
  if (lane == 0) {
    for (int s = 0; s < kRing; ++s) bar_init(&sm.bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int j = 0; j < min(kRing, len); ++j)
      bulk_row(sm.row[j], x + static_cast<size_t>(col[j]) * f + c0, bytes, &sm.bar[j]);
  }
  __syncwarp();
  for (int j = 0; j < len; ++j) {
    const int s = j % kRing;
    bar_wait(&sm.bar[s], static_cast<uint32_t>(j / kRing) & 1u);
    if (lane * 4 < f - c0) {
      const float4 t = sm.row[s][lane];
      const float v[4] = {t.x, t.y, t.z, t.w};
      use(j, v);
    }
    __syncwarp();
    if (lane == 0 && j + kRing < len)
      bulk_row(sm.row[s], x + static_cast<size_t>(col[j + kRing]) * f + c0, bytes, &sm.bar[s]);
  }
}

"""

PLAIN_CALL = """  gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; },
                                        [&](int j, const float (&v)[VEC]) {
                                          const float wj = round_to<T>(val[j]);
#pragma unroll
                                          for (int i = 0; i < VEC; ++i)
                                            acc[i] = fmaf(wj, v[i], acc[i]);
                                        });"""

BULK_CALL = """  const auto use = [&](int j, const float (&v)[VEC]) {
    const float wj = round_to<T>(val[j]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
  };
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    if (log2_g == 5) {
      bulk_gather(sm, col, wu.len, x, f, static_cast<int>(blockIdx.y), use);
    } else {
      gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; }, use);
    }
  } else {
    gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; }, use);
  }"""

PLAIN_CALL = """  gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; },
                                        [&](int j, const float (&v)[VEC]) {
                                          const float wj = round_to<T>(val[j]);
#pragma unroll
                                          for (int i = 0; i < VEC; ++i)
                                            acc[i] = fmaf(wj, v[i], acc[i]);
                                        });"""

BULK_CALL = """  const auto use = [&](int j, const float (&v)[VEC]) {
    const float wj = round_to<T>(val[j]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wj, v[i], acc[i]);
  };
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    if (log2_g == 5) {
      bulk_gather(sm, col, wu.len, x, f, static_cast<int>(blockIdx.y), use);
    } else {
      gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; }, use);
    }
  } else {
    gather_units<VEC, kRowsInFlight<VEC>>(col, wu, rl, x, f, [](int) { return true; }, use);
  }"""

SHIPPED_SMEM = """struct WarpSmem {
  UnitSmem r;
  float val[kUnitSlots];
};"""
PASS1 = "// Pass 1:"
VARIANTS["bulk"] = [("bell_spmm.cu", SHIPPED_SMEM, BULK_SMEM),
                    ("bell_spmm.cu", PLAIN_CALL, BULK_CALL),
                    ("bell_spmm.cu", PASS1, BULK_HELPERS + PASS1)]


def variant_sources(csrc: str, out_dir: str, subs) -> str:
    """The three sources copied into `out_dir` with `subs` (file, shipped
    text, variant text) applied; returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    for name in SOURCES:
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        for file, shipped, text in subs:
            if file == name:
                if src.count(shipped) != 1:
                    raise RuntimeError(f"{name} no longer has the setting this script varies: "
                                       f"{shipped!r}")
                src = src.replace(shipped, text)
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(src)
    return out_dir


PASS1_KERNELS = r"(spmm_unit_kernel|attn_fwd_kernel|attn_bwd1_kernel|attn_bwd2_kernel)"


def spills(log: str) -> list[str]:
    """ptxas's non-zero spill reports of the pass-1 kernels in a build log."""
    out, entry = [], ""
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and any(int(v) for v in m.groups()) and re.search(PASS1_KERNELS, entry):
            kernel = re.search(PASS1_KERNELS + r"I\w+?Ev", entry)
            out.append(f"{kernel.group(0) if kernel else entry}: {m.group(0)}")
    return out


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "unit_variants.json"))
    ap.add_argument("--variants", nargs="+", default=None,
                    help="variants to build and time beside the shipped build")
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="time only the cases whose name holds one of these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    from gala_tpu_torch.data.datasets import load_dataset
    from gala_tpu_torch.data.ell import bell_order
    from gala_tpu_torch.data.reordering import apply_reorder
    from gala_tpu_torch.ops.graph import Graph
    from gala_tpu_torch.ops.kernels import attn_bell as ak
    from gala_tpu_torch.ops.kernels import bell_spmm as ks
    from gala_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC_DIR, build_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    names = ["shipped"] + [n for n in (args.variants or VARIANTS) if n != "shipped"]
    jobs = {}  # (variant, module): the build of the sources it changes
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        for name in names:
            subs = VARIANTS[name]
            d = variant_sources(CSRC_DIR, os.path.join(BUILD_DIR, f"var_{name}"), subs)
            for mod, stem in ((ks, "bell_spmm"), (ak, "attn_bell")):
                touched = {f"{stem}.cu", "unit_gather.cuh"} & {file for file, _, _ in subs}
                if touched or name == "shipped":
                    jobs[name, mod] = pool.submit(build_library, os.path.join(d, f"{stem}.cu"),
                                                  f"{stem}_{name}", mod.FUNCTIONS)
    builds, spilled = {}, {}
    for name in names:
        builds[name] = {mod: (jobs.get((name, mod)) or jobs["shipped", mod]).result()
                        for mod in (ks, ak)}
        spilled[name] = [s for b in builds[name].values() for s in spills(b.log)]
        print(f"{name}: spills {spilled[name] or 'none'}")

    @contextlib.contextmanager
    def use(name):
        shipped = ks.build, ak.build
        ks.build, ak.build = (lambda: builds[name][ks]), (lambda: builds[name][ak])
        try:
            yield
        finally:
            ks.build, ak.build = shipped

    host = load_dataset("Arxiv", None, 1.0)[0]
    gcn = Graph.from_host(apply_reorder(host, bell_order(host))[0], strategy="bell",
                          device="cuda")
    gat_host = apply_reorder(host, bell_order(host, split_diag=False))[0]
    gat = Graph.from_host(gat_host, strategy="bell", device="cuda", attention=True)
    dyn = Graph.from_host(gat_host, strategy="bell", device="cuda", dynamic_sample=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"

        def rand(*shape, dtype=dtype):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        for f in (32, 128):
            x = rand(gcn.c_pad, f)
            cases.append((f"bell_spmm {tag} F={f}",
                          lambda x=x: (ks.bell_spmm(gcn.bell, x, gcn.n_pad),)))
        for hf, nh in ((32, 1), (40, 1), (64, 8)):
            x, vl, vr = rand(gat.c_pad, hf), rand(gat.c_pad, nh), rand(gat.n_pad, nh)
            cases.append((f"attn_fwd {tag} hf={hf} H={nh}",
                          lambda x=x, vl=vl, vr=vr: ak.attn_fwd(gat.attn.fwd, x, vl, vr, 0.2,
                                                                gat.n_pad, True)))
            dout = rand(gat.n_pad, hf)
            with use("shipped"):
                out, m, s, _, _ = ak.attn_fwd(gat.attn.fwd, x, vl, vr, 0.2, gat.n_pad, False)
            w_tab = torch.cat([dout.float(), vr.float(), m, s, ak.per_head_dot(dout, out, nh)],
                              dim=1)
            cases.append((f"attn_bwd1 {tag} hf={hf} H={nh}",
                          lambda x=x, vl=vl, vr=vr, dout=dout, m=m, s=s:
                          ak.attn_bwd1(gat.attn.fwd, x, vl, vr, dout, m, s, 0.2)))
            cases.append((f"attn_bwd2 {tag} hf={hf} H={nh}",
                          lambda x=x, vl=vl, w_tab=w_tab:
                          (ak.attn_bwd2(gat.attn.t, x, vl, w_tab, 0.2, gat.c_pad),)))
        x = rand(dyn.c_pad, 32)
        cases.append((f"bell_spmm sampled {tag} F=32",
                      lambda x=x: (ks.bell_spmm_sampled(dyn.bell, x, dyn.n_pad, dyn.dyn_f, 20, 96,
                                                        96, True),)))
    if args.kernels:
        cases = [(k, c) for k, c in cases if any(sub in k for sub in args.kernels)]
    times = {}
    for key, call in cases:
        with use("shipped"):
            want = call()
        for name in names:
            with use(name):
                got = call()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want) if a is not None):
                raise AssertionError(f"{key}: {name} differs from the shipped build")
        runs = {name: [] for name in names}
        for r in range(args.runs):  # the variants in turns, run by run
            for name in (names if r % 2 == 0 else names[::-1]):
                with use(name):
                    runs[name].append(cuda_ms(call))
        times[key] = {name: [statistics.median(ts), min(ts), max(ts)]
                      for name, ts in runs.items()}
        print(key, ", ".join(f"{n} {t[0]:.4f} ({t[1]:.4f}-{t[2]:.4f})"
                             for n, t in times[key].items()), "ms; bitwise equal")
    summary = {"device": smi, "runs": args.runs, "spills": spilled,
               "ms_median_min_max": times}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
