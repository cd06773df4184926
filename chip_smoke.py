#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gala_tpu_torch) once on one NVIDIA GPU and
check it.  Usage, from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, exits non-zero
and prints no "ok" line:

1. device   needs torch.cuda; prints the card's name and power limit.
2. build    builds the bell SpMM kernel from gala_tpu_torch/csrc/ with
            nvcc (sm_90a) into gala_tpu_torch/_build/.
3. train    the port's main path, as a user calls it: compile
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

It ends with a JSON line of the kernels, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-4
WIDTHS = (1, 32, 128)
KERNEL_SOURCE = "gala_tpu_torch/csrc/bell_spmm.cu"
REPLACES = "gala_tpu/ops/pallas/bell_spmm.py:440"


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


def hub_graph(device):
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
    return host, Graph.from_host(host, strategy="bell", device=device)


def phase_train(gala_tpu_torch, kernel):
    from __graft_entry__ import GCN_DSL

    kernel.counts.reset()
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    import gala_tpu_torch
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel

    build = kernel.build()
    print(f"[build] {build.path} in {build.seconds:.1f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    cm, launches = phase_train(gala_tpu_torch, kernel)
    max_err, timings = phase_kernel(cm, kernel)

    t_kernel, t_plain = timings[("arxiv full bell", 32)]
    print(json.dumps({"kernels": [{
        "name": "bell_spmm", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": t_kernel, "plain_ms": t_plain,
        "at": "arxiv full bell, F=32",
    }]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
