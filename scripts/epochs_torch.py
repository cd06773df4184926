#!/usr/bin/env python3
"""Epoch times of the port's GCN and fused-GAT training, on one NVIDIA GPU.

    python3 scripts/epochs_torch.py [--runs 5] [--epochs 20] [--models gcn,gat]

Compiles __graft_entry__.GCN_DSL and GAT_DSL on the Arxiv stand-in
(scale 1.0, strategy auto -> bell) with gala_tpu_torch, then calls
`train(iters=epochs, warmup=2)` `runs` times on each.  Prints every run's
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
    sources = {"gcn": GCN_DSL, "gat": GAT_DSL}
    summary = {}
    for name in args.models.split(","):
        cm = gala_tpu_torch.compile_source(sources[name], mode="train", scale=1.0,
                                           device="cuda")
        runs = []
        for _ in range(args.runs):
            res = cm.train(iters=args.epochs, warmup=2)
            runs.append((res.total_time, res.inference_time, res.max_accuracy))
            print(f"{name}: train {res.total_time * 1e3:.4f} ms/epoch, inference "
                  f"{res.inference_time * 1e3:.4f} ms/epoch, max accuracy "
                  f"{res.max_accuracy:.5f}")
        med = [statistics.median(r[i] for r in runs) for i in range(3)]
        summary[name] = {"train_ms": med[0] * 1e3, "inference_ms": med[1] * 1e3,
                         "max_accuracy": med[2],
                         "train_ms_runs": [r[0] * 1e3 for r in runs],
                         "inference_ms_runs": [r[1] * 1e3 for r in runs]}
        print(f"{name}: median of {args.runs} x {args.epochs} epochs: train "
              f"{med[0] * 1e3:.4f} ms/epoch, inference {med[1] * 1e3:.4f} ms/epoch, max "
              f"accuracy {med[2]:.5f}")
        del cm
    print(json.dumps({"device": smi, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
