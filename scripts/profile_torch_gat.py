#!/usr/bin/env python3
"""Where the time of the port's GAT training goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_gat.py [--epochs 10] [--trace gat_trace.json]

Compiles __graft_entry__.GAT_DSL on the Arxiv stand-in (scale 1.0) with
gala_tpu_torch, warms up with one short training run, then profiles one
`train()` call with torch.profiler, as scripts/profile_torch_gcn.py does
for GCN: device time by kernel, the device's busy share of the profiled
wall time, the card's name and power limit.  Then times the three
attention kernels on the full layouts at the path's widths (hf 32 and 40,
one head) with CUDA events, on all rows, on the degree-bin rows alone and
on the hub rows alone.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_torch_gcn import _cuda_ms, profile_train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import gala_tpu_torch
    from __graft_entry__ import GAT_DSL

    cm = gala_tpu_torch.compile_source(GAT_DSL, mode="train", scale=1.0, device="cuda")
    profile_train(cm, args.epochs, args.trace)
    split_kernel_time(cm.full_graphs[0])
    return 0


def _rows(lay, lo, hi):
    """The layout restricted to row descriptors [lo, hi)."""
    return dataclasses.replace(lay, row_start=lay.row_start[lo:hi], row_len=lay.row_len[lo:hi],
                               row_node=lay.row_node[lo:hi])


def split_kernel_time(g) -> None:
    """Each attention kernel on all rows, bin rows only and hub rows only
    (the hub rows are the last n_big row descriptors of each layout)."""
    from gala_tpu_torch.ops.kernels import attn_bell as ak

    slope = 0.2
    parts = {}
    for side, lay in (("fwd", g.attn.fwd), ("t", g.attn.t)):
        nb = lay.n_real - lay.n_big
        hub_len = lay.row_len[nb:]
        print(f"attention layout {side}: {lay.n_big} hub rows with {int(hub_len.sum())} slots "
              f"(longest {int(hub_len.max()) if lay.n_big else 0}), "
              f"{int(lay.row_len[:nb].sum())} bin-row slots")
        parts[side] = {"all rows": lay, "bin rows": _rows(lay, 0, nb),
                       "hub rows": _rows(lay, nb, lay.n_real)}
    for hf in (32, 40):
        rand = lambda *shape: torch.randn(shape, device="cuda")  # noqa: E731
        x, vl, vr, dout = rand(g.c_pad, hf), rand(g.c_pad, 1), rand(g.n_pad, 1), rand(g.n_pad, hf)
        out, m, s, _, _ = ak.attn_fwd(g.attn.fwd, x, vl, vr, slope, g.n_pad, False)
        w_tab = torch.cat([dout, vr, m, s, ak.per_head_dot(dout, out, 1)], dim=1)
        calls = {
            "attn_fwd (flash)": ("fwd", lambda lay: ak.attn_fwd(lay, x, vl, vr, slope, g.n_pad,
                                                                True)),
            "attn_fwd (no flash)": ("fwd", lambda lay: ak.attn_fwd(lay, x, vl, vr, slope,
                                                                   g.n_pad, False)),
            "attn_bwd1": ("fwd", lambda lay: ak.attn_bwd1(lay, x, vl, vr, dout, m, s, slope)),
            "attn_bwd2": ("t", lambda lay: ak.attn_bwd2(lay, x, vl, w_tab, slope, g.c_pad)),
        }
        for name, (side, fn) in calls.items():
            times = ", ".join(f"{part} {_cuda_ms(lambda lay=lay: fn(lay)):.4f} ms"
                              for part, lay in parts[side].items())
            print(f"{name} hf={hf}: {times}")


if __name__ == "__main__":
    sys.exit(main())
