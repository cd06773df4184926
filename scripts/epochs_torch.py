#!/usr/bin/env python3
"""Epoch times of the port's GCN and fused-GAT training, on one NVIDIA GPU.

    python3 scripts/epochs_torch.py [--runs 5] [--epochs 20] [--models gcn,gat]
                                    [--dtypes f32,bf16]

Compiles __graft_entry__.GCN_DSL and GAT_DSL on the Arxiv stand-in
(scale 1.0, strategy auto -> bell) with gala_tpu_torch, at each of
`dtypes` (bf16: dtype=torch.bfloat16, bf16 activations with f32 params),
then calls `train(iters=epochs, warmup=2)` `runs` times on each, the
dtypes of a model taking turns run by run (in reverse order every other
run), so a drift of the card or host falls on both.  Prints every run's
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
    sources = {"gcn": GCN_DSL, "gat": GAT_DSL}
    dtypes = args.dtypes.split(",")
    torch_dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    summary = {}
    for model in args.models.split(","):
        cms = {dt: gala_tpu_torch.compile_source(sources[model], mode="train", scale=1.0,
                                                 device="cuda", dtype=torch_dtypes[dt])
               for dt in dtypes}
        runs = {dt: [] for dt in dtypes}
        for i in range(args.runs):
            for dt in (dtypes if i % 2 == 0 else dtypes[::-1]):
                res = cms[dt].train(iters=args.epochs, warmup=2)
                runs[dt].append((res.total_time, res.inference_time, res.max_accuracy))
                print(f"{model} {dt}: train {res.total_time * 1e3:.4f} ms/epoch, inference "
                      f"{res.inference_time * 1e3:.4f} ms/epoch, max accuracy "
                      f"{res.max_accuracy:.5f}")
        for dt in dtypes:
            name = model if dt == "f32" else f"{model}_{dt}"
            med = [statistics.median(r[i] for r in runs[dt]) for i in range(3)]
            summary[name] = {"train_ms": med[0] * 1e3, "inference_ms": med[1] * 1e3,
                             "max_accuracy": med[2],
                             "train_ms_runs": [r[0] * 1e3 for r in runs[dt]],
                             "inference_ms_runs": [r[1] * 1e3 for r in runs[dt]]}
            print(f"{name}: median of {args.runs} x {args.epochs} epochs: train "
                  f"{med[0] * 1e3:.4f} ms/epoch, inference {med[1] * 1e3:.4f} ms/epoch, max "
                  f"accuracy {med[2]:.5f}")
        del cms
    print(json.dumps({"device": smi, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
