#!/usr/bin/env python3
"""Epoch times of the port's GCN and fused-GAT training, on one NVIDIA GPU.

    python3 scripts/epochs_torch.py [--runs 5] [--epochs 20] [--models gcn,gat]
                                    [--dtypes f32,bf16]

Compiles __graft_entry__.GCN_DSL and GAT_DSL on the Arxiv stand-in
(scale 1.0, strategy auto -> bell) with gala_tpu_torch, at each of
`dtypes` (bf16: dtype=torch.bfloat16, bf16 activations with f32 params),
then calls `train(iters=epochs, warmup=2)` `runs` times on each, every
compiled program taking its turn run by run (in reverse order every
other run), so a drift of the card or host falls on all of them.  The
models gcn_data, gcn_kernel and gcn_dynamic are GCN_DSL under table7's
sampling lines (scripts/evaluate.py job_table7, k = 20): table7 in one
call is `--models gcn,gcn_data,gcn_kernel,gcn_dynamic --epochs 100`.  Prints every run's
train and inference seconds per epoch (TrainResult, host clock around
work that ends in a synchronize) and max test accuracy, their medians,
the card's name and power limit, and one JSON line of the medians.
Imports only the public API, so the same file runs against an older
tree of the package (put it in that tree's scripts/).  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--models", default="gcn,gat")
    ap.add_argument("--dtypes", default="f32", help="comma-separated: f32, bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import gala_tpu_torch
    from __graft_entry__ import GAT_DSL, GCN_DSL

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"{smi}; package {os.path.dirname(gala_tpu_torch.__file__)}")
    sources = {"gcn": GCN_DSL, "gat": GAT_DSL, "gcn_data": GCN_DSL + "G=G.sample(20);",
               "gcn_kernel": GCN_DSL + "aggrFn=aggrFn.sample(20);",
               "gcn_dynamic": GCN_DSL + "aggrFn=aggrFn.sample(20).dynamic();"}
    torch_dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    cms = {(model if dt == "f32" else f"{model}_{dt}"): gala_tpu_torch.compile_source(
               sources[model], mode="train", scale=1.0, device="cuda", dtype=torch_dtypes[dt])
           for model in args.models.split(",") for dt in args.dtypes.split(",")}
    names = list(cms)
    runs = {name: [] for name in names}
    for i in range(args.runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            res = cms[name].train(iters=args.epochs, warmup=2)
            runs[name].append((res.total_time, res.inference_time, res.max_accuracy))
            print(f"{name}: train {res.total_time * 1e3:.4f} ms/epoch, inference "
                  f"{res.inference_time * 1e3:.4f} ms/epoch, max accuracy "
                  f"{res.max_accuracy:.5f}")
    summary = {}
    for name in names:
        med = [statistics.median(r[i] for r in runs[name]) for i in range(3)]
        summary[name] = {"train_ms": med[0] * 1e3, "inference_ms": med[1] * 1e3,
                         "max_accuracy": med[2],
                         "train_ms_runs": [r[0] * 1e3 for r in runs[name]],
                         "inference_ms_runs": [r[1] * 1e3 for r in runs[name]]}
        print(f"{name}: median of {args.runs} x {args.epochs} epochs: train "
              f"{med[0] * 1e3:.4f} ms/epoch, inference {med[1] * 1e3:.4f} ms/epoch, max "
              f"accuracy {med[2]:.5f}")
    print(json.dumps({"device": smi, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
