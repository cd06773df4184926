#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gala_tpu_torch) once on one NVIDIA GPU and
check it.  Usage, from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, exits non-zero
and prints no "ok" line:

1. device   needs torch.cuda; prints the card's name and power limit.
2. build    builds both kernel libraries from gala_tpu_torch/csrc/ (the
            bell SpMM and the three attention kernels), one nvcc each,
            started together, for sm_90a into gala_tpu_torch/_build/.
3. train    the port's GCN path, as a user calls it: compile
            __graft_entry__.GCN_DSL (2-layer GCN, hidden 32) on the Arxiv
            stand-in at full size (scale 1.0, strategy auto -> bell) on
            "cuda", then train 20 epochs (warmup 2).  The kernel's launch
            counts are zeroed just before and read just after; the run
            must have launched the kernel and never run the plain version
            on the card, with finite falling loss and test accuracy >= 0.7.
4. kernel   the kernel against its plain PyTorch version on the card, on
            the layouts of that run (the full graph, a training subgraph
            and its transpose) and on a generated graph with hubs,
            self-loops and isolated rows, at F = 1, 32 and 128 (plus
            ragged widths on the generated graph).  Tolerance, per
            element, in f32: |kernel - plain| <= 1e-4 + 1e-4 * (|A| @ |x|).
            A row's rounding error grows with the magnitudes of its terms
            (up to 6,656 on a hub row), not with the result, which
            cancellation can make small; the two sum in different orders,
            and the plain version's hub sum (index_add_) is not even
            bitwise reproducible on CUDA.  Then the kernel's and the plain
            version's times at the path's shapes (CUDA events, after a
            warm-up).
5. gat      the port's GAT path: compile __graft_entry__.GAT_DSL (2-layer
            GAT, hidden 32, one head) on the Arxiv stand-in at full size on
            "cuda" (strategy auto -> bell, fused attention layout) and
            train 20 epochs (warmup 2).  Every launch count is zeroed just
            before and read just after: the attention forward and bwd2
            kernels must have launched, no plain version may have run on
            the card, the bell SpMM must not have launched; finite falling
            loss and max test accuracy >= 0.6.
6. attn-kernel  the three attention kernels against their plain versions
            on the card (ops.kernels.attn_bell.compare_with_plain, whose
            docstring states the tolerance: 1e-4 + 1e-4 * the magnitudes
            of the summed terms), bwd1 also against the flash identity, on
            the GAT run's full-graph and training-subgraph layouts and on
            the generated hub graph, at (hf, H) = (32, 1), (40, 1), (32, 4);
            then attention_aggregate forward and backward on the hub graph
            on the card against the same call on CPU tensors (same
            tolerance form); then each kernel's and plain version's times
            at the GAT path's shapes.

It ends with a JSON line of the kernels (launches on the main path of each
kernel's phase, and in the kernel phase), the nvidia-smi line, and the
last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-4
WIDTHS = (1, 32, 128)
KERNEL_SOURCE = "gala_tpu_torch/csrc/bell_spmm.cu"
REPLACES = "gala_tpu/ops/pallas/bell_spmm.py:440"
ATTN_SOURCE = "gala_tpu_torch/csrc/attn_bell.cu"
ATTN_REPLACES = {
    "attn_fwd": "gala_tpu/ops/pallas/attn_bell.py:174",
    "attn_bwd1": "gala_tpu/ops/pallas/attn_bell.py:307",
    "attn_bwd2": "gala_tpu/ops/pallas/attn_bell.py:456",
}
ATTN_SHAPES = ((32, 1), (40, 1), (32, 4))  # (hf, H); the GAT path runs (32, 1), (40, 1)
SLOPE = 0.2


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, from CUDA events around `reps` calls
    after a warm-up."""
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


def hub_graph(device, attention=False):
    """Weighted directed graph on 5,000 nodes: node 0 has in-degree 3,000
    (24 virtual rows), node 1 out-degree 2,000 (a hub of the transpose),
    every second node a self-loop, the last 500 nodes no edges."""
    from gala_tpu_torch.data.csr import coo_to_csr
    from gala_tpu_torch.ops.graph import Graph

    rng = np.random.default_rng(0)
    n = 5000
    src = np.concatenate([rng.integers(0, 4500, 40000), rng.integers(0, 4500, 3000),
                          np.full(2000, 1), np.arange(0, 4500, 2)])
    dst = np.concatenate([rng.integers(0, 4500, 40000), np.zeros(3000, np.int64),
                          rng.integers(0, 4500, 2000), np.arange(0, 4500, 2)])
    vals = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
    host = coo_to_csr(src, dst, vals, n_rows=n)
    return host, Graph.from_host(host, strategy="bell", device=device, attention=attention)


def phase_train(gala_tpu_torch, kernel):
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.ops.kernels._build import reset_counts

    reset_counts()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", scale=1.0, device="cuda")
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    print(f"[train] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges, {int(cm.x.shape[1])} features, {cm.n_classes} classes, "
          f"{g.bell.flat_cols.shape[0]} slots, {len(g.bell.bin_ks)} bins, {g.bell.n_big} hubs")
    t0 = time.perf_counter()
    res = cm.train(iters=20, warmup=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = kernel.counts.launches
    on_cuda = kernel.counts.reference_calls_on_cuda
    print(f"[train] csv {res.csv(print_accuracy=True)}")
    print(f"[train] seconds/epoch: train {res.total_time:.6f}, inference {res.inference_time:.6f};"
          f" 20 epochs with accuracy in {train_s:.1f} s")
    print(f"[train] losses {json.dumps([round(v, 5) for v in res.losses])}")
    print(f"[train] accuracies {json.dumps([round(v, 5) for v in res.accuracies])}")
    print(f"[train] bell_spmm launches {launches}, plain-version calls on cuda {on_cuda}")
    print(f"[train] peak memory allocated {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")

    if g.strategy != "bell":
        raise AssertionError(f"strategy {g.strategy}, expected bell")
    if launches <= 0:
        raise AssertionError("the main path never launched the bell SpMM kernel")
    if on_cuda != 0:
        raise AssertionError(f"the main path ran the plain SpMM on the card {on_cuda} times")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"loss did not fall: {res.losses[0]} -> {res.losses[-1]}")
    if res.max_accuracy < 0.7:
        raise AssertionError(f"max test accuracy {res.max_accuracy} < 0.7")
    with torch.no_grad():
        logits = cm.forward(res.params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
    if logits.shape != (g.n_pad, cm.n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or not (n_pad, classes)")
    return cm, launches


def phase_kernel(cm, kernel):
    from gala_tpu_torch.data.csr import densify

    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    if sub.bell.out_index is None or sub.t_bell is sub.bell:
        raise AssertionError("the training subgraph should have its own order and transpose")
    gen = torch.Generator(device="cuda").manual_seed(0)
    layouts = [
        ("arxiv full bell", full.bell, full.c_pad, full.n_pad),
        ("arxiv subgraph bell", sub.bell, sub.c_pad, sub.n_pad),
        ("arxiv subgraph t_bell", sub.t_bell, sub.n_pad, sub.c_pad),
    ]
    hub_host, hub = hub_graph("cuda")
    layouts += [("hub graph bell", hub.bell, hub.c_pad, hub.n_pad),
                ("hub graph t_bell", hub.t_bell, hub.n_pad, hub.c_pad)]

    max_err = 0.0
    for name, lay, rows, n_out in layouts:
        if (lay.flat_vals < 0).any() or (lay.diag is not None and (lay.diag < 0).any()):
            raise AssertionError(f"{name}: negative values, |A| @ |x| needs |A|")
        for f in WIDTHS + ((33, 40) if name.startswith("hub") else ()):
            x = torch.randn((rows, f), generator=gen, device="cuda")
            out = kernel.bell_spmm(lay, x, n_out)
            ref = kernel.bell_spmm_reference(lay, x, n_out)
            scale = kernel.bell_spmm_reference(lay, x.abs(), n_out)  # |A| @ |x|
            err = (out - ref).abs()
            bad = int((err > ATOL + RTOL * scale).sum())
            max_err = max(max_err, err.max().item())
            print(f"[kernel] {name} F={f}: max |kernel - plain| {err.max().item():.3e}, "
                  f"max of that / (|A| @ |x|) {(err / scale.clamp_min(1e-30)).max().item():.3e}, "
                  f"{bad} elements out of tolerance")
            if bad:
                raise AssertionError(f"{name} F={f}: {bad} elements out of tolerance")
    # the generated graph against the dense product, in float64
    x = torch.randn((hub.c_pad, 32), generator=gen, device="cuda")
    a = torch.from_numpy(densify(hub_host)).double()
    dense = a @ x[: hub.n_cols].double().cpu()
    scale = a @ x[: hub.n_cols].double().abs().cpu()
    out = kernel.bell_spmm(hub.bell, x, hub.n_pad)[: hub.n_nodes].double().cpu()
    err = (out - dense).abs()
    print(f"[kernel] hub graph F=32 vs dense A @ x in float64: max err {err.max().item():.3e}")
    if (err > ATOL + RTOL * scale).any():
        raise AssertionError("the kernel disagrees with the dense product")

    timings = {}
    for name, lay, rows, n_out in layouts[:3]:
        for f in WIDTHS:
            x = torch.randn((rows, f), generator=gen, device="cuda")
            t_kernel = cuda_ms(lambda: kernel.bell_spmm(lay, x, n_out), reps=20)
            t_plain = cuda_ms(lambda: kernel.bell_spmm_reference(lay, x, n_out), reps=5)
            timings[(name, f)] = (t_kernel, t_plain)
            print(f"[kernel] time {name} F={f}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms")
    return max_err, timings


def phase_gat(gala_tpu_torch):
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(GAT_DSL, mode="train", scale=1.0, device="cuda")
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    ops = [n.op.name for n in cm.program.loop.nodes]
    print(f"[gat] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges; program {','.join(ops)}")
    if g.attn is not None:
        for side, lay in (("fwd", g.attn.fwd), ("t", g.attn.t)):
            print(f"[gat] attention layout {side}: {lay.flat_cols.shape[0]} slots, "
                  f"{len(lay.bin_ks)} bins, {lay.n_big} hubs, longest row "
                  f"{int(lay.row_len.max())} slots")
    t0 = time.perf_counter()
    res = cm.train(iters=20, warmup=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in all_counts().items()}
    on_cuda = {name: c.reference_calls_on_cuda for name, c in all_counts().items()}
    print(f"[gat] csv {res.csv(print_accuracy=True)}")
    print(f"[gat] seconds/epoch: train {res.total_time:.6f}, inference {res.inference_time:.6f};"
          f" 20 epochs with accuracy in {train_s:.1f} s")
    print(f"[gat] losses {json.dumps([round(v, 5) for v in res.losses])}")
    print(f"[gat] accuracies {json.dumps([round(v, 5) for v in res.accuracies])}")
    print(f"[gat] kernel launches {json.dumps(launches)}, plain-version calls on cuda "
          f"{json.dumps(on_cuda)}")
    print(f"[gat] peak memory allocated {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")

    if g.strategy != "bell" or g.attn is None:
        raise AssertionError(f"strategy {g.strategy}, attention layout {g.attn is not None}: "
                             "expected bell with the fused attention layout")
    if ops.count("FUSED_ATTENTION") != 2:
        raise AssertionError(f"expected two fused attention ops, program {ops}")
    for name in ("attn_fwd", "attn_bwd2"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the GAT path never launched the {name} kernel")
    if any(on_cuda.values()):
        raise AssertionError(f"the GAT path ran plain versions on the card: {on_cuda}")
    if launches.get("bell_spmm", 0):
        raise AssertionError(f"the GAT path launched the bell SpMM {launches['bell_spmm']} times")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"loss did not fall: {res.losses[0]} -> {res.losses[-1]}")
    if res.max_accuracy < 0.6:
        raise AssertionError(f"max test accuracy {res.max_accuracy} < 0.6")
    with torch.no_grad():
        logits = cm.forward(res.params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
    if logits.shape != (g.n_pad, cm.n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or not (n_pad, classes)")
    return cm, launches


def _aggregate_on(device, ab, g, inputs):
    """attention_aggregate forward + backward of sum(out * dout) on `device`."""
    from gala_tpu_torch.ops.attention import attention_aggregate

    x, vl, vr, dout = (t.to(device) for t in inputs)
    for t in (x, vl, vr):
        t.requires_grad_(True)
    out = attention_aggregate(g.n_pad, g.c_pad, SLOPE, ab, x, vl, vr)
    (out * dout).sum().backward()
    return [t.detach().cpu() for t in (out, x.grad, vl.grad, vr.grad)]


def phase_attn_kernel(cm, ak):
    """Returns (max |kernel - plain| per kernel, times)."""
    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    hub = hub_graph("cuda", attention=True)[1]
    graphs = [("arxiv full", full), ("arxiv training subgraph", sub), ("hub graph", hub)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731

    max_err = {name: 0.0 for name in ak.NAMES}
    for gname, g in graphs:
        for hf, nh in ATTN_SHAPES:
            res = ak.compare_with_plain(g.attn, rand(g.c_pad, hf), rand(g.c_pad, nh),
                                        rand(g.n_pad, nh), rand(g.n_pad, hf), SLOPE,
                                        g.n_pad, g.c_pad)
            torch.cuda.synchronize()
            bad = {k: v for k, v in res.items() if v[1]}
            print(f"[attn-kernel] {gname} hf={hf} H={nh}: max |kernel - plain| "
                  + ", ".join(f"{k} {v[0]:.2e}" for k, v in res.items())
                  + f"; {sum(v[1] for v in res.values())} elements out of tolerance")
            if bad:
                raise AssertionError(f"{gname} hf={hf} H={nh}: out of tolerance {bad}")
            for k, (err, _) in res.items():
                name = "attn_" + k.split()[0]
                if "=" not in k:
                    max_err[name] = max(max_err[name], err)

    # the op with its autograd on the card against the same op on CPU tensors
    hub_cpu = hub_graph("cpu", attention=True)[1]
    cpu_gen = torch.Generator().manual_seed(1)
    for hf, nh in ATTN_SHAPES:
        inputs = [torch.randn(shape, generator=cpu_gen) for shape in
                  ((hub.c_pad, hf), (hub.c_pad, nh), (hub.n_pad, nh), (hub.n_pad, hf))]
        got = _aggregate_on("cuda", hub.attn, hub, inputs)
        want = _aggregate_on("cpu", hub_cpu.attn, hub_cpu, inputs)
        scales = ak.aggregate_scales(hub_cpu.attn, *inputs, SLOPE, hub.n_pad, hub.c_pad)
        errs = []
        for name, gt, wt, sc in zip(("out", "dx", "dvl", "dvr"), got, want, scales):
            err = (gt - wt).abs()
            errs.append(f"{name} {err.max().item():.2e}")
            if (err > 1e-4 + 1e-4 * sc).any():
                raise AssertionError(f"attention_aggregate hf={hf} H={nh}: {name} on the card "
                                     f"differs from CPU by {err.max().item():.3e}")
        print(f"[attn-kernel] attention_aggregate hub graph hf={hf} H={nh}, card vs cpu: "
              + ", ".join(errs))

    timings = {}
    lay_f, lay_t = full.attn.fwd, full.attn.t
    for hf, nh in ATTN_SHAPES[:2]:
        x, vl = rand(full.c_pad, hf), rand(full.c_pad, nh)
        vr, dout = rand(full.n_pad, nh), rand(full.n_pad, hf)
        out, m, s, _, _ = ak.attn_fwd(lay_f, x, vl, vr, SLOPE, full.n_pad, False)
        sds = ak.per_head_dot(dout, out, nh)
        w_tab = torch.cat([dout, vr, m, s, sds], dim=1)
        calls = {
            "attn_fwd": (lambda: ak.attn_fwd(lay_f, x, vl, vr, SLOPE, full.n_pad, True),
                         lambda: ak.attn_fwd_reference(lay_f, x, vl, vr, SLOPE, full.n_pad,
                                                       True)),
            "attn_bwd1": (lambda: ak.attn_bwd1(lay_f, x, vl, vr, dout, m, s, SLOPE),
                          lambda: ak.attn_bwd1_reference(lay_f, x, vl, vr, dout, m, s, SLOPE)),
            "attn_bwd2": (lambda: ak.attn_bwd2(lay_t, x, vl, w_tab, SLOPE, full.c_pad),
                          lambda: ak.attn_bwd2_reference(lay_t, x, vl, w_tab, SLOPE,
                                                         full.c_pad)),
        }
        for name, (kern, plain) in calls.items():
            t_kernel = cuda_ms(kern, reps=20)
            t_plain = cuda_ms(plain, reps=5)
            timings[(name, hf)] = (t_kernel, t_plain)
            print(f"[attn-kernel] time {name} arxiv full hf={hf} H={nh}: kernel "
                  f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms")
    return max_err, timings


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    import gala_tpu_torch
    from gala_tpu_torch.ops.kernels import attn_bell as ak
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel
    from gala_tpu_torch.ops.kernels._build import all_counts

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = [pool.submit(kernel.build), pool.submit(ak.build)]
        builds = [b.result() for b in builds]
    for build in builds:
        print(f"[build] {build.path} in {build.seconds:.1f} s")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")

    cm, launches = phase_train(gala_tpu_torch, kernel)
    max_err, timings = phase_kernel(cm, kernel)
    del cm
    gat, gat_launches = phase_gat(gala_tpu_torch)
    before = {name: c.launches for name, c in all_counts().items()}
    attn_err, attn_timings = phase_attn_kernel(gat, ak)
    phase_launches = {name: c.launches - before.get(name, 0) for name, c in all_counts().items()}

    t_kernel, t_plain = timings[("arxiv full bell", 32)]
    kernels = [{
        "name": "bell_spmm", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": t_kernel, "plain_ms": t_plain,
        "at": "arxiv full bell, F=32", "path": "gcn",
    }]
    for name in ak.NAMES:
        t_kernel, t_plain = attn_timings[(name, 32)]
        kernels.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": ATTN_REPLACES[name], "launches": gat_launches.get(name, 0),
            "kernel_phase_launches": phase_launches.get(name, 0),
            "max_abs_err": attn_err[name], "ms": t_kernel, "plain_ms": t_plain,
            "at": "arxiv full attention layout, hf=32, H=1",
            "path": "gat" if name != "attn_bwd1" else "kernel phase only (the GAT path "
                                                      "takes the flash identity)",
        })
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
