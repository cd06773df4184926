#!/usr/bin/env python3
"""Where the time of the port's unfused GAT training goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_gat_edge.py [--epochs 10] [--trace gat_edge_trace.json]

Compiles __graft_entry__.GAT_DSL with the attention_fusion pass off (the
edge-valued chain: SDDVV-add, leaky ReLU, edge softmax, SpMM with edge
values, and the SDDMM in its backward) on the Arxiv stand-in (scale 1.0,
strategy auto -> ell) with gala_tpu_torch, and profiles one `train()`
call with torch.profiler, as scripts/profile_torch_gcn.py does for GCN.
Then times, with CUDA events at the path's widths (F 32 and 40), the
SpMM kernel with per-slot values on the ELL layout and its transpose (all
rows, rows of at most 128 slots, longer rows alone) and the SDDMM kernel
against its plain version.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_torch_gcn import _cuda_ms, profile_train  # noqa: E402

_LONG_ROW = 128  # slots: the binned layout's hub threshold (data.ell.BIN_SIZES[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import gala_tpu_torch
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.dsl.parser import parse_source

    spec = parse_source(GAT_DSL)
    spec.passes.attention_fusion = False
    cm = gala_tpu_torch.compile_model(spec, mode="train", scale=1.0, device="cuda")
    profile_train(cm, args.epochs, args.trace)
    split_kernel_time(cm.full_graphs[0])
    return 0


def split_kernel_time(g) -> None:
    from gala_tpu_torch.ops.graph import select_rows
    from gala_tpu_torch.ops.kernels import sddmm as ks
    from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm

    evals = torch.rand((g.e_pad,), device="cuda")
    for side, lay, rows, n_out in (("ell", g.ell, g.c_pad, g.n_pad),
                                   ("t_ell", g.t_ell, g.n_pad, g.c_pad)):
        long = lay.row_len > _LONG_ROW
        print(f"{side}: K {lay.k}, {int(long.sum())} rows over {_LONG_ROW} slots with "
              f"{int(lay.row_len[long].sum())} slots (longest {int(lay.row_len.max())}), "
              f"{int(lay.row_len[~long].sum())} slots in the other rows")
        parts = {"all rows": lay, "short rows": select_rows(lay, ~long),
                 "long rows": select_rows(lay, long)}
        vals = lay.slot_values(evals)
        for f in (32, 40):
            x = torch.randn((rows, f), device="cuda")
            times = ", ".join(
                f"{name} {_cuda_ms(lambda p=p: bell_spmm(p, x, n_out, vals=vals)):.4f} ms"
                for name, p in parts.items())
            print(f"bell_spmm with slot values on {side} F={f}: {times}")
    for f in (32, 40):
        a, b = torch.randn((g.c_pad, f), device="cuda"), torch.randn((g.n_pad, f), device="cuda")
        t_kernel = _cuda_ms(lambda: ks.sddmm(g.src, g.dst, a, b))
        t_plain = _cuda_ms(lambda: ks.sddmm_reference(g.src, g.dst, a, b), reps=5)
        print(f"sddmm F={f}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
