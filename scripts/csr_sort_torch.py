#!/usr/bin/env python3
"""Compile seconds of the native CSR build: the stable counting sort
(gala_tpu_torch/native/csr_stable.cpp, what data.csr.coo_to_csr runs above
1,000,000 edges) against the atomic-cursor sort of the copied
csr_ops.cpp it replaced (native.coo_to_csr_cursors) and the NumPy stable
path (argsort(dst, kind="stable")), on the synthetic stand-ins at full
size.

For each dataset it generates the stand-in and compiles
GCN_DSL on it (`lower`: the bell_order relabel and the training
subgraphs), with every native CSR build of both steps timed and repeated
on the same inputs with the other two routes, whose results it holds to
the stable sort's (the NumPy path bitwise).  A stand-in read from the
dataset cache (GALA_DATASET_CACHE, the generator's own) builds no CSR and
stops the script; one it generates is cached as usual, so a later
process (scripts/evaluate_torch.py) reads it.  With --turns it then
compiles GCN_DSL again from the generated data, stable and cursor sorts in
turns (stable, cursors, cursors, stable): the compile seconds before and
after the repair.  Prints one JSON line a dataset.

Usage, on a machine with the card:
    python3 scripts/csr_sort_torch.py --datasets Arxiv --turns
    python3 scripts/csr_sort_torch.py --datasets Reddit
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", nargs="+", default=["Arxiv"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--turns", action="store_true",
                    help="also time whole compiles, stable and cursor sorts in turns")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch import native
    from gala_tpu_torch.data import csr
    from gala_tpu_torch.data.datasets import load_dataset

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("csr_sort_torch.py: no CUDA device; pass --device cpu for a CPU run")
    if not native.available():
        raise SystemExit("csr_sort_torch.py: the native library did not build")
    card = "cpu"
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    stable = native.coo_to_csr_native
    print(f"# {card}; native threads {native.thread_count()}, host cores {os.cpu_count()}")

    def numpy_path(src, dst, vals, n_rows):
        native.coo_to_csr_native = lambda *a: None
        try:
            g = csr.coo_to_csr(src, dst, vals, n_rows=n_rows)
        finally:
            native.coo_to_csr_native = measured
        return g.row_ptr, g.src, g.dst, g.vals

    calls = []

    def measured(src, dst, vals, n_rows):
        times, outs = {}, {}
        for name, fn in (("stable", stable), ("cursors", native.coo_to_csr_cursors),
                         ("numpy", numpy_path)):
            t0 = time.perf_counter()
            outs[name] = fn(src, dst, vals, n_rows)
            times[name] = time.perf_counter() - t0
        same = {name: all(np.array_equal(a, b) for a, b in zip(outs[name], outs["stable"]))
                for name in ("numpy", "cursors")}
        if not same["numpy"]:
            raise AssertionError("the stable native sort differs from the NumPy stable path")
        calls.append({"edges": int(np.asarray(src).shape[0]), "rows": int(n_rows),
                      **{f"{k}_s": v for k, v in times.items()},
                      "cursors_equal_stable": same["cursors"]})
        print(f"  native CSR build: {calls[-1]}", flush=True)
        return outs["stable"]

    for name in args.datasets:
        calls.clear()
        native.coo_to_csr_native = measured
        try:
            t0 = time.perf_counter()
            data = load_dataset(name, None, args.scale)
            gen_s = time.perf_counter() - t0
            if not calls:
                raise SystemExit(f"csr_sort_torch.py: {name} came from the dataset cache "
                                 "and built no CSR; point GALA_DATASET_CACHE at an empty "
                                 "directory")
            gen_calls = len(calls)
            t0 = time.perf_counter()
            cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", data=data,
                                               device=args.device, strategy="bell")
            compile_s = time.perf_counter() - t0
        finally:
            native.coo_to_csr_native = stable
        g = cm.full_graphs[0]
        del cm
        out = {"dataset": name, "scale": args.scale, "nodes": g.n_nodes, "edges": g.n_edges,
               "card": card, "generate_s": gen_s, "generate_calls": gen_calls,
               "compile_s": compile_s,
               "generate_and_compile_s_include_the_other_routes": True, "calls": calls,
               **{f"native_builds_{k}_s": sum(c[f"{k}_s"] for c in calls)
                  for k in ("stable", "cursors", "numpy")}}
        if args.turns:
            turns = {"stable": [], "cursors": []}
            for route in ("stable", "cursors", "cursors", "stable"):
                native.coo_to_csr_native = (stable if route == "stable"
                                            else native.coo_to_csr_cursors)
                try:
                    t0 = time.perf_counter()
                    gala_tpu_torch.compile_source(GCN_DSL, mode="train", data=data,
                                                  device=args.device, strategy="bell")
                    if args.device != "cpu":
                        torch.cuda.synchronize()
                    turns[route].append(time.perf_counter() - t0)
                finally:
                    native.coo_to_csr_native = stable
            out["compile_s_in_turns"] = turns
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
