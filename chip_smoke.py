#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gala_tpu_torch) once on one NVIDIA GPU and
check it.  Usage, from the repository root:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises, exits non-zero
and prints no "ok" line:

1. device   needs torch.cuda; prints the card's name and power limit.
2. build    builds the three kernel libraries from gala_tpu_torch/csrc/
            (the bell SpMM, the three attention kernels, the SDDMM), one
            nvcc each, started together, for sm_90a into
            gala_tpu_torch/_build/.
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
7. gat-edge the port's edge-valued GAT path: GAT_DSL with the
            attention_fusion pass off (the reference GALA's own GAT: SDDVV,
            leaky ReLU, edge softmax, SpMM with edge values) on the Arxiv
            stand-in at full size on "cuda", strategy auto -> ell, 20
            epochs (warmup 2).  The SpMM kernel (forward and dx on the ELL
            layouts, per-slot values) and the SDDMM kernel (the values'
            gradient) must have launched, no attention kernel and no plain
            version on the card; finite falling loss, max test accuracy
            >= 0.6.
8. sddmm-kernel  the SDDMM kernel against its plain version on the card,
            on that run's full-graph and training-subgraph edge lists at
            F = 32 and 40 and on the generated hub graph's at F = 1, 33,
            40 and 128.  Tolerance per edge, in f32: |kernel - plain| <=
            1e-4 + 1e-4 * sum_f |a||b| (the plain version on |a|, |b|).
            Then the SpMM kernel with learned per-slot values on the ELL
            layout and its transpose against the row-descriptor plain
            version (phase 4's tolerance form), on the full graph and
            every training subgraph at F = 1, 32, 40 and 128 (the widths
            phases 7 and 9 give it) and on the generated hub graph at F =
            1, 33, 40 and 128; then the SDDMM kernel's and
            plain version's times at F = 32 and 40 on the full graph.
9. gcn-sparser  GCN_DSL with `G = G.is_sparser(true);` (the sparsity-
            aware rewrite: precomputed edge values norm_src * norm_dst)
            on the same graph, strategy auto -> ell, 20 epochs: the SpMM
            kernel must have launched and the SDDMM kernel not (the
            values need no gradient); finite falling loss, max test
            accuracy >= 0.7.

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
SDDMM_SOURCE = "gala_tpu_torch/csrc/sddmm.cu"
SDDMM_REPLACES = "gala_tpu/ops/pallas/sddmm.py:183"


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


def hub_graph(device, attention=False, strategy="bell"):
    """Weighted directed graph on 5,000 nodes: node 0 has in-degree 3,000
    (24 virtual rows of the binned layout), node 1 out-degree 2,000 (a hub
    of the transpose), every second node a self-loop, the last 500 nodes
    no edges."""
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
    return host, Graph.from_host(host, strategy=strategy, device=device, attention=attention,
                                 edge_vals=strategy != "bell")


def _train_checked(tag, cm, min_accuracy):
    """20 epochs (warmup 2) of a compiled model with every launch count
    zeroed just before; prints and checks the run.  Returns the result
    and the run's launches by kernel."""
    from gala_tpu_torch.ops.kernels._build import all_counts, reset_counts

    reset_counts()
    t0 = time.perf_counter()
    res = cm.train(iters=20, warmup=2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in all_counts().items()}
    on_cuda = {name: c.reference_calls_on_cuda for name, c in all_counts().items()}
    print(f"[{tag}] csv {res.csv(print_accuracy=True)}")
    print(f"[{tag}] seconds/epoch: train {res.total_time:.6f}, inference "
          f"{res.inference_time:.6f}; 20 epochs with accuracy in {train_s:.1f} s")
    print(f"[{tag}] losses {json.dumps([round(v, 5) for v in res.losses])}")
    print(f"[{tag}] accuracies {json.dumps([round(v, 5) for v in res.accuracies])}")
    print(f"[{tag}] kernel launches {json.dumps(launches)}, plain-version calls on cuda "
          f"{json.dumps(on_cuda)}")
    print(f"[{tag}] peak memory allocated {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
    if any(on_cuda.values()):
        raise AssertionError(f"[{tag}] the path ran plain versions on the card: {on_cuda}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"[{tag}] non-finite loss: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        raise AssertionError(f"[{tag}] loss did not fall: {res.losses[0]} -> {res.losses[-1]}")
    if res.max_accuracy < min_accuracy:
        raise AssertionError(f"[{tag}] max test accuracy {res.max_accuracy} < {min_accuracy}")
    g = cm.full_graphs[0]
    with torch.no_grad():
        logits = cm.forward(res.params, cm.full_graphs, cm.invariant(cm.full_graphs, cm.x))
    if logits.shape != (g.n_pad, cm.n_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"[{tag}] logits {tuple(logits.shape)} not finite or not "
                             "(n_pad, classes)")
    return res, launches


def phase_train(gala_tpu_torch):
    from __graft_entry__ import GCN_DSL

    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", scale=1.0, device="cuda")
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    print(f"[train] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges, {int(cm.x.shape[1])} features, {cm.n_classes} classes, "
          f"{g.bell.flat_cols.shape[0]} slots, {len(g.bell.bin_ks)} bins, {g.bell.n_big} hubs")
    if g.strategy != "bell":
        raise AssertionError(f"strategy {g.strategy}, expected bell")
    _, launches = _train_checked("train", cm, 0.7)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("the main path never launched the bell SpMM kernel")
    return cm, launches["bell_spmm"]


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

    torch.cuda.reset_peak_memory_stats()
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
    if g.strategy != "bell" or g.attn is None:
        raise AssertionError(f"strategy {g.strategy}, attention layout {g.attn is not None}: "
                             "expected bell with the fused attention layout")
    if ops.count("FUSED_ATTENTION") != 2:
        raise AssertionError(f"expected two fused attention ops, program {ops}")
    _, launches = _train_checked("gat", cm, 0.6)
    for name in ("attn_fwd", "attn_bwd2"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the GAT path never launched the {name} kernel")
    if launches.get("bell_spmm", 0):
        raise AssertionError(f"the GAT path launched the bell SpMM {launches['bell_spmm']} times")
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


def _compile_spec(tag, spec):
    import gala_tpu_torch

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cm = gala_tpu_torch.compile_model(spec, mode="train", scale=1.0, device="cuda")
    compile_s = time.perf_counter() - t0
    g = cm.full_graphs[0]
    ops = [(n.op.name, len(n.inputs)) for n in cm.program.all_nodes()]
    print(f"[{tag}] compiled in {compile_s:.1f} s: strategy {g.strategy}, {g.n_nodes} nodes, "
          f"{g.n_edges} edges (e_pad {g.e_pad}); program "
          f"{','.join(name for name, _ in ops)}")
    if g.ell is not None:
        for side, lay in (("fwd", g.ell), ("t", g.t_ell)):
            print(f"[{tag}] ELL layout {side}: K {lay.k}, {lay.flat_cols.shape[0]} slots "
                  f"({int(lay.row_len.sum())} in rows), longest row "
                  f"{int(lay.row_len.max())} slots")
    if g.strategy != "ell":
        raise AssertionError(f"[{tag}] strategy {g.strategy}, expected ell")
    return cm, ops


def phase_gat_edge():
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.dsl.parser import parse_source

    spec = parse_source(GAT_DSL)
    spec.passes.attention_fusion = False
    cm, ops = _compile_spec("gat-edge", spec)
    names = [name for name, _ in ops]
    if ("AGGREGATE_EDGE_SUM" not in names or "SOFTMAX" not in names
            or ("AGGREGATE_MUL_SUM", 3) not in ops or "FUSED_ATTENTION" in names):
        raise AssertionError(f"[gat-edge] not the unfused GAT chain: {ops}")
    _, launches = _train_checked("gat-edge", cm, 0.6)
    for name in ("sddmm", "bell_spmm"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"[gat-edge] the path never launched the {name} kernel")
    attn = {k: v for k, v in launches.items() if k.startswith("attn_") and v}
    if attn:
        raise AssertionError(f"[gat-edge] the path launched attention kernels: {attn}")
    return cm, launches


def phase_gcn_sparser():
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.dsl.parser import parse_source

    spec = parse_source(GCN_DSL + "\nG = G.is_sparser(true);\n")
    if not spec.graph.sparser:
        raise AssertionError("[gcn-sparser] the schedule did not set is_sparser")
    cm, ops = _compile_spec("gcn-sparser", spec)
    if ("AGGREGATE_EDGE_MUL" not in [name for name, _ in ops]
            or ("AGGREGATE_MUL_SUM", 3) not in ops):
        raise AssertionError(f"[gcn-sparser] not the sparse rewrite: {ops}")
    _, launches = _train_checked("gcn-sparser", cm, 0.7)
    if launches.get("bell_spmm", 0) <= 0:
        raise AssertionError("[gcn-sparser] the path never launched the bell SpMM kernel")
    if launches.get("sddmm", 0) != 0:
        raise AssertionError(f"[gcn-sparser] the path launched the SDDMM kernel "
                             f"{launches['sddmm']} times: its edge values need no gradient")
    return launches


def phase_sddmm_kernel(cm, ks, kernel):
    """Returns (max |kernel - plain| of the SDDMM, of the SpMM with slot
    values, times)."""
    full, sub = cm.full_graphs[0], cm.train_graphs[0]
    hub = hub_graph("cuda", strategy="ell")[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    cases = [("arxiv full", full, (32, 40)), ("arxiv training subgraph", sub, (32, 40)),
             ("hub graph", hub, (1, 33, 40, 128))]
    max_err = 0.0
    for name, g, widths in cases:
        for f in widths:
            a, b = rand(g.c_pad, f), rand(g.n_pad, f)
            out = ks.sddmm(g.src, g.dst, a, b)
            ref = ks.sddmm_reference(g.src, g.dst, a, b)
            scale = ks.sddmm_reference(g.src, g.dst, a.abs(), b.abs())
            err = (out - ref).abs()
            bad = int((err > ATOL + RTOL * scale).sum())
            max_err = max(max_err, err.max().item())
            print(f"[sddmm-kernel] {name} ({g.e_pad} edges) F={f}: max |kernel - plain| "
                  f"{err.max().item():.3e}, max of that / (sum |a||b|) "
                  f"{(err / scale.clamp_min(1e-30)).max().item():.3e}, {bad} out of tolerance")
            if bad:
                raise AssertionError(f"[sddmm-kernel] {name} F={f}: {bad} edges out of tolerance")

    # every ELL layout and width the gat-edge and gcn-sparser paths give the
    # SpMM with slot values: 32/40 in training, 128 and 1 in the hoisted
    # prefix on the full graph
    spmm_cases = [("arxiv full", full, (1, 32, 40, 128))]
    spmm_cases += [(f"arxiv training subgraph {i}", t, (1, 32, 40, 128))
                   for i, t in enumerate(cm.train_graphs)]
    spmm_cases += [("hub graph", hub, (1, 33, 40, 128))]
    spmm_err = 0.0
    for name, g, widths in spmm_cases:
        evals = torch.rand((g.e_pad,), generator=gen, device="cuda")
        for side, lay, rows, n_out in (("ell", g.ell, g.c_pad, g.n_pad),
                                       ("t_ell", g.t_ell, g.n_pad, g.c_pad)):
            vals = lay.slot_values(evals)
            for f in widths:
                x = rand(rows, f)
                out = kernel.bell_spmm(lay, x, n_out, vals=vals)
                ref = kernel.bell_spmm_rows_reference(lay, x, n_out, vals)
                scale = kernel.bell_spmm_rows_reference(lay, x.abs(), n_out, vals)
                err = (out - ref).abs()
                bad = int((err > ATOL + RTOL * scale).sum())
                spmm_err = max(spmm_err, err.max().item())
                print(f"[sddmm-kernel] bell_spmm with slot values, {name} {side} F={f}: "
                      f"max |kernel - plain| {err.max().item():.3e}, {bad} out of tolerance")
                if bad:
                    raise AssertionError(f"bell_spmm slot values {name} {side} F={f}: {bad} "
                                         "elements out of tolerance")

    timings = {}
    for f in (32, 40):
        a, b = rand(full.c_pad, f), rand(full.n_pad, f)
        t_kernel = cuda_ms(lambda: ks.sddmm(full.src, full.dst, a, b), reps=20)
        t_plain = cuda_ms(lambda: ks.sddmm_reference(full.src, full.dst, a, b), reps=5)
        timings[("sddmm", f)] = (t_kernel, t_plain)
        print(f"[sddmm-kernel] time sddmm arxiv full F={f}: kernel {t_kernel:.4f} ms, "
              f"plain {t_plain:.4f} ms")
        evals = torch.rand((full.e_pad,), generator=gen, device="cuda")
        vals = full.ell.slot_values(evals)
        x = rand(full.c_pad, f)
        t_kernel = cuda_ms(lambda: kernel.bell_spmm(full.ell, x, full.n_pad, vals=vals), reps=20)
        t_plain = cuda_ms(lambda: kernel.bell_spmm_rows_reference(full.ell, x, full.n_pad, vals),
                          reps=5)
        timings[("bell_spmm ell", f)] = (t_kernel, t_plain)
        print(f"[sddmm-kernel] time bell_spmm on the ELL layout with slot values, arxiv full "
              f"F={f}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms")
    return max_err, spmm_err, timings


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    import gala_tpu_torch
    from gala_tpu_torch.ops.kernels import attn_bell as ak
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel
    from gala_tpu_torch.ops.kernels import sddmm as ks
    from gala_tpu_torch.ops.kernels._build import all_counts

    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(kernel.build), pool.submit(ak.build), pool.submit(ks.build)]
        builds = [b.result() for b in builds]
    for build in builds:
        print(f"[build] {build.path} in {build.seconds:.1f} s")
        for line in build.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")

    cm, launches = phase_train(gala_tpu_torch)
    max_err, timings = phase_kernel(cm, kernel)
    del cm
    gat, gat_launches = phase_gat(gala_tpu_torch)
    before = {name: c.launches for name, c in all_counts().items()}
    attn_err, attn_timings = phase_attn_kernel(gat, ak)
    phase_launches = {name: c.launches - before.get(name, 0) for name, c in all_counts().items()}
    del gat
    gat_edge, edge_launches = phase_gat_edge()
    sddmm_err, ev_err, sddmm_timings = phase_sddmm_kernel(gat_edge, ks, kernel)
    del gat_edge
    sparser_launches = phase_gcn_sparser()

    t_kernel, t_plain = timings[("arxiv full bell", 32)]
    kernels = [{
        "name": "bell_spmm", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max(max_err, ev_err), "ms": t_kernel,
        "plain_ms": t_plain, "at": "arxiv full bell, F=32",
        "path": "gcn, gat-edge, gcn-sparser",
        "path_launches": {"gcn": launches, "gat-edge": edge_launches.get("bell_spmm", 0),
                          "gcn-sparser": sparser_launches.get("bell_spmm", 0)},
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
    t_kernel, t_plain = sddmm_timings[("sddmm", 32)]
    kernels.append({
        "name": "sddmm", "route": "cuda", "source": SDDMM_SOURCE, "replaces": SDDMM_REPLACES,
        "launches": edge_launches.get("sddmm", 0), "max_abs_err": sddmm_err, "ms": t_kernel,
        "plain_ms": t_plain, "at": "arxiv full edge list, F=32", "path": "gat-edge",
        "path_launches": {"gat-edge": edge_launches.get("sddmm", 0),
                          "gcn-sparser": sparser_launches.get("sddmm", 0)},
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
