#!/usr/bin/env python3
"""Time the four unit kernels of gala_tpu_torch (the bell SpMM, the
attention forward, bwd1 and bwd2), the SDDMM and the sampled SpMM at the
paths' shapes on the Arxiv stand-in, in f32 and bf16, on one NVIDIA GPU,
beside each call's bound and, for the SpMM at f32, `torch.sparse.mm` on
the same matrix.  Usage, from the root of a tree:

    python3 scripts/unit_kernels_torch.py [--label NAME] [--graph arxiv|reddit]
        [--kernels SUBSTRING ...]

The SpMM runs on the GCN's full bell (bell_order with the diagonal split)
at F = 1, 32, 128, and on the unfused GAT's ELL layout with per-slot
values at F = 32, 40; the attention kernels on the fused GAT's layouts
(bell_order without the split): the forward at hf = 32, 40 and 41 with
one head and at hf = 64, 40 and 328 (8 heads of 41, pitch 44) with 8
heads, bwd1 and bwd2 at BWD_SHAPES
(bwd2's table built as the tree's backward builds it: by
attn_bell.bwd2_table where the tree has it); the SDDMM
on the unfused GAT's padded edge lists (2,102,667 edges) at F = 32 and
40, a (c_pad, F) and b (n_pad, F), the two calls of its backward; one
sampled SpMM call (dynamic sampling, k = 20, one epoch's (ra, rb)) at F
= 32, forward and transpose, on the full-graph and first training
subgraph layouts of GCN_DSL + `aggrFn=aggrFn.sample(20).dynamic();`:
bell_spmm_sampled, and the SpMM run on weights made beforehand (the
kernel's gather and sums alone).  `--graph reddit` times the
attention kernels alone, on the fused GAT's layouts of the benchmark's
Reddit-shaped graph (gala_bench/graphgen.py, traffic `reddit`: 232,965
nodes, 114,827,317 nonzeros; its layouts take about two minutes to
build).  --kernels keeps the cases whose
name holds one of the given substrings.  Each time is
the median of 5 runs of 20 calls (CUDA events, after a warm-up), with the
runs' min and max; beside it the device time of a call (torch.profiler's
CUDA activity: its kernels and memsets), which differs where the host
launches slower than the card runs (the small calls).  The bound is the
larger of the bytes the call must move (each input once, each output
once) over 3.35 TB/s and its
operations over 67 TFLOP/s (NVIDIA's H100 SXM data sheet).  To compare
two trees on one card, unpack the other tree (git archive) into a
git-ignored directory, copy this script into its scripts/, and run it
from each root in one chip call, in turns: parent, change, change,
parent.  Prints the card's name and power limit, then one JSON line
{"label", "device", "times": {kernel shape: [median, min, max]},
"bounds": {kernel shape: ms}, "device_ms": {kernel shape: ms}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

SLOPE = 0.2
# (hf, H) of the forward, and of bwd1 and bwd2: the GAT path's one head at
# hf = 32 and 40, the Reddit GAT's output layer at 41, and 8 heads (fh = 4
# and 8 in 4-column lanes, fh = 5 at a row pitch of 8 where the tree pads,
# the 8-head GAT's output layer fh = 41 at a pitch of 44)
FWD_SHAPES = ((32, 1), (40, 1), (41, 1), (64, 8), (40, 8), (328, 8))
BWD_SHAPES = ((32, 1), (40, 1), (41, 1), (32, 8), (64, 8), (40, 8), (328, 8))
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over `reps` calls, by CUDA events, after a warm-up."""
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


def runs(fn, n: int = 5) -> list:
    t = sorted(cuda_ms(fn) for _ in range(n))
    return [statistics.median(t), t[0], t[-1]]


def device_ms(fn, reps: int = 20) -> float:
    """ms of device work per call (every kernel and memset the call
    launches, by torch.profiler's CUDA activity), after a warm-up: what
    the call costs the card, where a host that launches slower than the
    card runs makes the events' time the host's."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps / 1e3


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: int, n_ops: int) -> float:
    """The least ms of a call: bytes over the HBM rate or operations over
    the f32 rate, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


def layout_bytes(lay, vals=None) -> int:
    return nbytes(lay.flat_cols, lay.flat_vals if vals is None else vals, lay.row_start,
                  lay.row_len, lay.row_node, getattr(lay, "diag", None))


def layout_csr(lay, n_out: int, n_src: int):
    """The matrix of a row-descriptor layout (and its diagonal) as a torch
    CSR tensor: the input of torch.sparse.mm."""
    lens = lay.row_len.long()
    first = torch.cumsum(lens, 0) - lens
    slot = (torch.repeat_interleave(lay.row_start - first, lens)
            + torch.arange(int(lens.sum()), device=lens.device))
    rows = torch.repeat_interleave(lay.row_node.long(), lens)
    cols, vals = lay.flat_cols.long()[slot], lay.flat_vals[slot]
    if lay.diag is not None:
        ids = torch.arange(lay.diag.shape[0], device=lens.device)
        rows, cols = torch.cat([rows, ids]), torch.cat([cols, ids])
        vals = torch.cat([vals, lay.diag[:, 0]])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n_out, n_src),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--graph", choices=("arxiv", "reddit"), default="arxiv",
                    help="the Arxiv stand-in (every kernel) or the benchmark's Reddit-shaped "
                         "graph (the attention kernels alone)")
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="time only the cases whose name holds one of these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("unit_kernels_torch.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)

    from gala_tpu_torch.data.datasets import load_dataset
    from gala_tpu_torch.data.ell import bell_order
    from gala_tpu_torch.data.reordering import apply_reorder
    from gala_tpu_torch.ops.graph import Graph
    from gala_tpu_torch.ops.kernels import attn_bell as ak
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel
    from gala_tpu_torch.ops.kernels import sddmm as ks

    reddit = args.graph == "reddit"
    if reddit:
        from gala_bench import graphgen

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, "gala_bench", "traffic", "reddit.json")) as f:
            g = graphgen.make_graph(json.load(f), "cuda")
        host = graphgen.host_data(g)[0]
        del g
        torch.cuda.empty_cache()
    else:
        data = load_dataset("Arxiv", None, 1.0)
        host = data[0]
        gcn = Graph.from_host(apply_reorder(host, bell_order(host))[0], strategy="bell",
                              device="cuda")
    gat_host = apply_reorder(host, bell_order(host, split_diag=False))[0]
    gat = Graph.from_host(gat_host, strategy="bell", device="cuda", attention=True)
    if not reddit:
        edge = Graph.from_host(gat_host, strategy="ell", device="cuda", edge_vals=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    times, bounds, device = {}, {}, {}

    def measure(key, fn):
        if args.kernels and not any(k in key for k in args.kernels):
            return
        times[key] = runs(fn)
        device[key] = device_ms(fn)

    if not reddit:
        csr = layout_csr(gcn.bell, gcn.n_pad, gcn.c_pad)
        evals = torch.rand((edge.e_pad,), generator=gen, device="cuda")
        ell_vals = edge.ell.slot_values(evals)
    fwd, t = gat.attn.fwd, gat.attn.t
    f32 = 4
    dyn = [] if reddit else sampled_layouts(data)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        for f in () if reddit else (1, 32, 128):
            x = rand(gcn.c_pad, f)
            key = f"bell_spmm {tag} F={f}"
            measure(key, lambda: kernel.bell_spmm(gcn.bell, x, gcn.n_pad))
            bounds[key] = bound(layout_bytes(gcn.bell) + 2 * nbytes(x),
                                2 * (gcn.bell.flat_cols.numel() + gcn.n_pad) * f)
            if dtype == torch.float32:
                measure(f"torch.sparse.mm f32 F={f}", lambda: torch.sparse.mm(csr, x))
        for f in () if reddit else (32, 40):
            x = rand(edge.c_pad, f)
            key = f"bell_spmm ell slot values {tag} F={f}"
            measure(key, lambda: kernel.bell_spmm(edge.ell, x, edge.n_pad, vals=ell_vals))
            bounds[key] = bound(layout_bytes(edge.ell, ell_vals) + nbytes(x)
                                + edge.n_pad * f * x.element_size(),
                                2 * edge.ell.flat_cols.numel() * f)
        for hf, nh in FWD_SHAPES:
            x, vl, vr = rand(gat.c_pad, hf), rand(gat.c_pad, nh), rand(gat.n_pad, nh)
            key = f"attn_fwd {tag} hf={hf} H={nh}"
            measure(key, lambda: ak.attn_fwd(fwd, x, vl, vr, SLOPE, gat.n_pad, True))
            bounds[key] = bound(layout_bytes(fwd) + nbytes(x, vl, vr)
                                + 2 * gat.n_pad * hf * f32 + 3 * gat.n_pad * nh * f32,
                                fwd.flat_cols.numel() * (4 * hf + 8 * nh))
        for hf, nh in BWD_SHAPES:
            x, vl, vr = rand(gat.c_pad, hf), rand(gat.c_pad, nh), rand(gat.n_pad, nh)
            dout = rand(gat.n_pad, hf)
            out, m, s, _, _ = ak.attn_fwd(fwd, x, vl, vr, SLOPE, gat.n_pad, False)
            w_tab = bwd2_table(ak, x, dout, vr, m, s, ak.per_head_dot(dout, out, nh))
            key = f"attn_bwd1 {tag} hf={hf} H={nh}"
            measure(key, lambda: ak.attn_bwd1(fwd, x, vl, vr, dout, m, s, SLOPE))
            bounds[key] = bound(layout_bytes(fwd) + nbytes(x, vl, vr, dout, m, s)
                                + 3 * gat.n_pad * nh * f32,
                                fwd.flat_cols.numel() * (2 * hf + 12 * nh))
            key = f"attn_bwd2 {tag} hf={hf} H={nh}"
            measure(key, lambda: ak.attn_bwd2(t, x, vl, w_tab, SLOPE, gat.c_pad))
            bounds[key] = bound(layout_bytes(t) + nbytes(x, vl)
                                + gat.n_pad * (hf + 4 * nh) * f32 + gat.c_pad * (hf + nh) * f32,
                                t.flat_cols.numel() * (4 * hf + 12 * nh))
        for f in () if reddit else (32, 40):
            a, b = rand(edge.c_pad, f), rand(edge.n_pad, f)
            key = f"sddmm {tag} F={f}"
            measure(key, lambda: ks.sddmm(edge.src, edge.dst, a, b))
            bounds[key] = bound(nbytes(edge.src, edge.dst, a, b) + edge.e_pad * a.element_size(),
                                2 * edge.e_pad * f)
        for name, lay, meta, rows, n_out in dyn:
            x = rand(rows, 32)
            key = f"bell_spmm sampled {tag} {name} F=32"
            measure(key, lambda: sampled_call(lay, x, n_out, meta))
            # deg, pos and the structural values in place of the slot values
            bounds[key] = bound(layout_bytes(lay) + nbytes(meta.deg, meta.pos, x)
                                + n_out * 32 * x.element_size(),
                                (2 * 32 + SAMPLE_K) * lay.flat_cols.numel())
            w = kernel.dyn_weights_reference(meta.deg, meta.pos, SAMPLE_K, RA, RB, lay.flat_vals)
            measure(f"bell_spmm on made weights {tag} {name} F=32",
                    lambda: kernel.bell_spmm(lay, x, n_out, vals=w))
    print(json.dumps({"label": args.label, "device": smi, "times": times, "bounds": bounds,
                      "device_ms": device}))
    return 0


def bwd2_table(ak, x, dout, vr, m, s, sds):
    """bwd2's w_tab as the tree's backward builds it: attn_bell.bwd2_table
    where the tree has it (its dout block at the kernel's row pitch), else
    [dout | vr | m | s | sds] as it stands."""
    if hasattr(ak, "bwd2_table"):
        return ak.bwd2_table(x, dout, vr, m, s, sds)
    return torch.cat([dout.float(), vr.float(), m, s, sds], dim=1)


SAMPLE_K, RA, RB = 20, 96, 96  # k of table7's dynamic schedule; one epoch's (ra, rb)


def sampled_layouts(data) -> list:
    """(name, layout, DynSlots, input rows, output rows) of each sampled
    SpMM call of one epoch of the dynamic GCN: forward and transpose on the
    full graph and on the first training subgraph."""
    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL

    cm = gala_tpu_torch.compile_source(GCN_DSL + "aggrFn=aggrFn.sample(20).dynamic();\n",
                                       mode="train", data=data, device="cuda")
    out = []
    for name, g in (("full", cm.full_graphs[0]), ("subgraph", cm.train_graphs[0])):
        out.append((f"{name} forward", g.bell, g.dyn_f, g.c_pad, g.n_pad))
        out.append((f"{name} transpose", g.t_bell, g.dyn_t, g.n_pad, g.c_pad))
    return out


def sampled_call(lay, x, n_out, meta):
    """One sampled SpMM call on 'bell' (the weights times the structural
    values)."""
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel

    return kernel.bell_spmm_sampled(lay, x, n_out, meta, SAMPLE_K, RA, RB, True)


if __name__ == "__main__":
    sys.exit(main())
