#!/usr/bin/env python3
"""Attention bwd2's gather, plain loads against a ring of cp.async copies,
on one NVIDIA GPU.

    python3 scripts/ring_vs_plain_torch.py [--runs 25] [--calls 10] [--out PATH]

bwd1 and bwd2 (csrc/attn_bell.cu) gather one unit a warp with plain
loads (csrc/unit_gather.cuh `gather_unit`); the SpMM and the forward
gather through `gather_units`, which scripts/unit_variants_torch.py
holds against bulk copies.  This script keeps the alternative plain
loads were measured against: RING below, a per-warp ring of two stages
of 16-byte cp.async.ca copies in shared memory, which the SpMM shipped
before.  It copies attn_bell.cu into gala_tpu_torch/_build/ring_src/
(git-ignored) beside a unit_gather.cuh whose `UnitSmem` and `gather_unit`
are RING's, and builds it as libattn_bell_ring_<hash>.so; nothing of the
package selects that build.  Compiles __graft_entry__.GAT_DSL on the
Arxiv stand-in (scale 1.0, strategy auto -> bell) and, on its full
graph, times bwd2 at hf = 32, 40, one head, on the transpose layout,
with CUDA events, each variant `runs` times (one run: `calls`
back-to-back calls between two events, after a warm-up), the variants in
turns run by run (ring, plain, plain, ring, ...).  First it checks that
both variants give the same result bit for bit (each lane sums the same
slots in the same order either way).  Prints each case's
median ms per call and its spread (min-max over the runs), the card's
name and power limit, and one JSON line; writes the same JSON to --out
(default results/ring_vs_plain.json, a git-ignored directory).  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("ring", "plain")
SLOPE = 0.2

# unit_gather.cuh's UnitSmem and gather_unit as the ring has them: each
# lane copies its 16 bytes of a slot's row into its stage of the ring and
# reads back only those, so cp.async.wait_group orders the ring without a
# barrier; rows that are not float4 take plain loads
RING_SMEM = """constexpr int kStages = 2;
struct UnitSmem {
  float4 ring[kStages][kWarp];
  int32_t col[kUnitSlots];
};"""
RING_GATHER = """__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

template <int VEC, class T, class Want, class Use>
__device__ __forceinline__ void gather_unit(const UnitSmem& csm, int len, const T* __restrict__ x,
                                            int f, const Lanes& ln, Want want, Use use) {
  if (!ln.active) return;
  const T* xv = x + static_cast<size_t>(ln.vcol) * VEC;
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    UnitSmem& sm = const_cast<UnitSmem&>(csm);  // the ring's stages
    const int n_steps = (len + ln.groups - 1) / ln.groups;
    auto fetch = [&](int q) {
      const int j = q * ln.groups + ln.sub;
      if (j < len && want(j))
        cp_async16(&sm.ring[q % kStages][ln.lane], xv + static_cast<size_t>(sm.col[j]) * f);
    };
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < n_steps) fetch(q);
      cp_async_commit();
    }
    for (int q = 0; q < n_steps; ++q) {
      // refill the stage consumed in step q - 1, then wait for stage q
      if (q + kStages - 1 < n_steps) fetch(q + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      const int j = q * ln.groups + ln.sub;
      if (j < len && want(j)) {
        const float4 t = sm.ring[q % kStages][ln.lane];
        const float v[4] = {t.x, t.y, t.z, t.w};
        use(j, v);
      }
    }
  } else {
#pragma unroll 4
    for (int j = ln.sub; j < len; j += ln.groups) {
      if (want(j)) {
        float v[VEC];
        load_vec<VEC>(xv + static_cast<size_t>(csm.col[j]) * f, v);
        use(j, v);
      }
    }
  }
}

"""


def ring_sources(csrc: str, out_dir: str) -> str:
    """attn_bell.cu copied into `out_dir` beside a unit_gather.cuh with
    RING's UnitSmem and gather_unit; returns out_dir."""
    with open(os.path.join(csrc, "unit_gather.cuh")) as f:
        hdr = f.read()
    smem = "struct UnitSmem {\n  int32_t col[kUnitSlots];\n};"
    first, last = "// The warp's gather of one unit", "// Several units a warp"
    if hdr.count(smem) != 1 or hdr.count(first) != 1 or hdr.count(last) != 1:
        raise RuntimeError("unit_gather.cuh no longer has the UnitSmem / gather_unit this "
                           "script replaces")
    hdr = hdr[:hdr.index(first)] + RING_GATHER + hdr[hdr.index(last):]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "unit_gather.cuh"), "w") as f:
        f.write(hdr.replace(smem, RING_SMEM))
    shutil.copyfile(os.path.join(csrc, "attn_bell.cu"), os.path.join(out_dir, "attn_bell.cu"))
    return out_dir


@contextlib.contextmanager
def variant(mod, build):
    """The module's wrappers launch from `build` (a Build of another
    variant) inside the block."""
    shipped = mod.build
    mod.build = lambda: build
    try:
        yield
    finally:
        mod.build = shipped


def event_runs(fn, runs: int, calls: int) -> list[float]:
    """ms per call of `runs` runs of `calls` calls each, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "ring_vs_plain.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import gala_tpu_torch
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.ops.kernels import attn_bell as ak
    from gala_tpu_torch.ops.kernels._build import BUILD_DIR, CSRC_DIR, build_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    ring_dir = ring_sources(CSRC_DIR, os.path.join(BUILD_DIR, "ring_src"))
    builds = {"plain": ak.build(),
              "ring": build_library(os.path.join(ring_dir, "attn_bell.cu"), "attn_bell_ring",
                                    ak.FUNCTIONS)}
    for name, b in builds.items():
        print(f"attn_bell {name}: {b.path}")

    gat = gala_tpu_torch.compile_source(GAT_DSL, mode="train", scale=1.0, device="cuda")
    ga = gat.full_graphs[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731

    cases = []  # (kernel, width, call)
    for hf in (32, 40):
        x, vl = rand(ga.c_pad, hf), rand(ga.c_pad, 1)
        vr, dout = rand(ga.n_pad, 1), rand(ga.n_pad, hf)
        out, m, s, _, _ = ak.attn_fwd_reference(ga.attn.fwd, x, vl, vr, SLOPE, ga.n_pad, False)
        w_tab = torch.cat([dout, vr, m, s, ak.per_head_dot(dout, out, 1)], dim=1)
        cases.append(("attn_bwd2", hf, lambda x=x, vl=vl, w=w_tab: ak.attn_bwd2(
            ga.attn.t, x, vl, w, SLOPE, ga.c_pad)))

    results = []
    for kernel, width, call in cases:
        outs = {}
        for name in VARIANTS:
            with variant(ak, builds[name]):
                res = call()
            outs[name] = res if isinstance(res, tuple) else (res,)
        same = all(torch.equal(a, b) for a, b in zip(outs["ring"], outs["plain"]))
        if not same:
            raise AssertionError(f"{kernel} at {width}: ring and plain loads differ")
        times = {name: [] for name in VARIANTS}
        for r in range(args.runs):  # the variants in turns, run by run
            for name in (("ring", "plain") if r % 2 == 0 else ("plain", "ring")):
                with variant(ak, builds[name]):
                    times[name] += event_runs(call, 1, args.calls)
        row = {"kernel": kernel, "width": width}
        for name, ts in times.items():
            row[name] = {"median_ms": statistics.median(ts), "min_ms": min(ts),
                         "max_ms": max(ts), "runs": len(ts)}
        row["plain_over_ring"] = row["plain"]["median_ms"] / row["ring"]["median_ms"]
        results.append(row)
        print(f"{kernel} width {width}: ring {row['ring']['median_ms']:.4f} ms "
              f"({row['ring']['min_ms']:.4f}-{row['ring']['max_ms']:.4f}), plain "
              f"{row['plain']['median_ms']:.4f} ms ({row['plain']['min_ms']:.4f}-"
              f"{row['plain']['max_ms']:.4f}), plain / ring {row['plain_over_ring']:.3f}; "
              f"results bitwise equal")
    summary = {"device": smi, "runs": args.runs, "calls_per_run": args.calls, "cases": results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
