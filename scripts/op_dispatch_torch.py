#!/usr/bin/env python3
"""Host time per call of the port's kernel bindings, on one NVIDIA GPU.

    python3 scripts/op_dispatch_torch.py [--runs 5] [--calls 200]

On the Arxiv stand-in (scale 1.0, strategy bell) at the paths' shapes
(the SpMM at F = 32 on the GCN's bell layout, the attention forward at
hf = 32, H = 1 on the GAT's fused layout), each binding is called
`calls` times back to back and the host clock read around the calls
(no synchronize inside: the time to enqueue them, which is what a
host-bound epoch pays), then once more around a synchronize (the wall
time with the device's work).  Bindings:

    direct        the ctypes wrapper (ops.kernels.bell_spmm.bell_spmm,
                  ops.kernels.attn_bell.attn_fwd), no autograd
    op            the custom op as the package registers it
                  (ops.kernels.library: torch.library.Library, an
                  Autograd kernel), under no_grad
    function      forward and backward through a torch.autograd.Function
                  over the direct wrappers: the form the ops replaced
                  (BellSpmm, AttentionAggregate; kept here)
    op-grad       forward and backward through the custom op
    custom_op     forward and backward through a copy of the SpMM op made
                  with torch.library.custom_op and register_autograd
                  (kept here; the package does not register it)
    custom_op-nograd  that copy under no_grad

Every variant takes its turn run by run.  Prints medians (µs per call)
with their min-max, the card's name and power limit, and one JSON line.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bindings(cm_gcn, cm_gat):
    from gala_tpu_torch.ops.kernels import attn_bell, library
    from gala_tpu_torch.ops.kernels import bell_spmm as kernel

    g = cm_gcn.full_graphs[0]
    bell, t_bell, n_pad, c_pad = g.bell, g.t_bell, g.n_pad, g.c_pad
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((c_pad, 32), generator=gen, device="cuda")
    dz = torch.randn((n_pad, 32), generator=gen, device="cuda")
    xg = x.clone().requires_grad_(True)

    class BellSpmm(torch.autograd.Function):  # the parent's form
        @staticmethod
        def forward(ctx, x, lay, t_lay, n_out, c_out):
            ctx.t_lay, ctx.c_out = t_lay, c_out
            return kernel.bell_spmm(lay, x, n_out)

        @staticmethod
        def backward(ctx, dz):
            return kernel.bell_spmm(ctx.t_lay, dz.contiguous(), ctx.c_out), None, None, None, None

    @torch.library.custom_op("op_dispatch::bell_spmm", mutates_args=(), device_types="cuda")
    def custom(x: torch.Tensor, lay: list[torch.Tensor], lay_ints: list[int],
               t_lay: list[torch.Tensor], t_ints: list[int], n_out: int,
               c_out: int) -> torch.Tensor:
        return kernel.bell_spmm_cuda(library.layout_of(lay, lay_ints, views=False), x, n_out)

    custom.register_fake(lambda x, lay, lay_ints, t_lay, t_ints, n_out, c_out:
                         x.new_empty((n_out, x.shape[1])))

    def setup(ctx, inputs, output):
        ctx.args = inputs[1:]

    def backward(ctx, dz):
        lay, lay_ints, t_lay, t_ints, n_out, c_out = ctx.args
        dx = custom(dz.contiguous(), t_lay, t_ints, lay, lay_ints, c_out, n_out)
        return dx, [None] * len(lay), None, [None] * len(t_lay), None, None, None

    custom.register_autograd(backward, setup_context=setup)
    la, ta = library.layout_args(bell), library.layout_args(t_bell)

    ga = cm_gat.full_graphs[0]
    ab = ga.attn
    xa = torch.randn((ga.c_pad, 32), generator=gen, device="cuda")
    vl = torch.randn((ga.c_pad, 1), generator=gen, device="cuda")
    vr = torch.randn((ga.n_pad, 1), generator=gen, device="cuda")
    douta = torch.randn((ga.n_pad, 32), generator=gen, device="cuda")
    xag, vlg, vrg = (t.clone().requires_grad_(True) for t in (xa, vl, vr))

    class Attention(torch.autograd.Function):  # the parent's AttentionAggregate
        @staticmethod
        def forward(ctx, x, vl, vr):
            out, m, s, outpos, spos = attn_bell.attn_fwd(ab.fwd, x, vl, vr, 0.2, ga.n_pad, True)
            ctx.save_for_backward(x, vl, vr, m, s, out, outpos, spos)
            return out

        @staticmethod
        def backward(ctx, dout):
            x, vl, vr, m, s, out, outpos, spos = ctx.saved_tensors
            sds = attn_bell.per_head_dot(dout, out, 1)
            dvr = 0.8 * (attn_bell.per_head_dot(dout, outpos, 1) - sds * spos)
            w_tab = torch.cat([dout, vr, m, s, sds], dim=1)
            dxx = attn_bell.attn_bwd2(ab.t, x, vl, w_tab, 0.2, ga.c_pad)
            return dxx[:, :32], dxx[:, 32:], dvr

    def nograd(fn):
        def call():
            with torch.no_grad():
                fn()
        return call

    return {
        "spmm direct": nograd(lambda: kernel.bell_spmm(bell, x, n_pad)),
        "spmm op": nograd(lambda: library.spmm(x, bell, t_bell, n_pad, c_pad)),
        "spmm custom_op-nograd": nograd(lambda: custom(x, *la, *ta, n_pad, c_pad)),
        "spmm function": lambda: BellSpmm.apply(xg, bell, t_bell, n_pad, c_pad).backward(dz),
        "spmm op-grad": lambda: library.spmm(xg, bell, t_bell, n_pad, c_pad).backward(dz),
        "spmm custom_op": lambda: custom(xg, *la, *ta, n_pad, c_pad).backward(dz),
        "attn direct": nograd(lambda: attn_bell.attn_fwd(ab.fwd, xa, vl, vr, 0.2, ga.n_pad,
                                                         False)),
        "attn op": nograd(lambda: library.attention(xa, vl, vr, ab, ga.n_pad, ga.c_pad, 0.2,
                                                    False)),
        "attn function": lambda: Attention.apply(xag, vlg, vrg).backward(douta),
        "attn op-grad": lambda: library.attention(xag, vlg, vrg, ab, ga.n_pad, ga.c_pad, 0.2,
                                                  True).backward(douta),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import gala_tpu_torch
    from __graft_entry__ import GAT_DSL, GCN_DSL
    from gala_tpu_torch.data.datasets import load_dataset

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    data = load_dataset("Arxiv", None, 1.0)
    cms = [gala_tpu_torch.compile_source(src, mode="train", data=data, strategy="bell",
                                         device="cuda") for src in (GCN_DSL, GAT_DSL)]
    calls = _bindings(*cms)
    names = list(calls)
    host = {n: [] for n in names}
    wall = {n: [] for n in names}
    for fn in calls.values():  # warm-up: builds, caches
        fn()
    torch.cuda.synchronize()
    for i in range(args.runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            fn = calls[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host[name].append((t1 - t0) / args.calls * 1e6)
            wall[name].append((t2 - t0) / args.calls * 1e6)
    summary = {}
    for name in names:
        summary[name] = {"host_us": statistics.median(host[name]),
                         "host_us_min_max": [min(host[name]), max(host[name])],
                         "wall_us": statistics.median(wall[name]),
                         "wall_us_min_max": [min(wall[name]), max(wall[name])]}
        s = summary[name]
        print(f"{name}: host {s['host_us']:.1f} us/call ({s['host_us_min_max'][0]:.1f}-"
              f"{s['host_us_min_max'][1]:.1f}), wall {s['wall_us']:.1f} us/call")
    print(json.dumps({"device": smi, "calls": args.calls, "runs": args.runs, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
