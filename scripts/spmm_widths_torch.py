#!/usr/bin/env python3
"""Count the bell SpMM's calls by feature width on the GCN path: compile
__graft_entry__.GCN_DSL on the Arxiv stand-in and train it as chip_smoke.py
does (20 epochs, warm-up 2), with the SpMM's kernel and plain version
wrapped to count each call under its x's width.

    python3 scripts/spmm_widths_torch.py [--device cpu] [--scale 1.0] [--iters 20]

A count is a count: on the CPU the plain version runs in the kernel's
place, and the calls are the same (PERF.md's launches by width).  Prints
one JSON line {"device", "scale", "iters", "calls_by_width": {F: n}}.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL
    from gala_tpu_torch.ops.kernels import bell_spmm as ks

    calls = collections.Counter()

    def counted(fn):
        def wrapper(bell, x, *rest, **kw):
            calls[int(x.shape[1])] += 1
            return fn(bell, x, *rest, **kw)
        return wrapper

    ks.bell_spmm_plain = counted(ks.bell_spmm_plain)
    ks.bell_spmm_cuda = counted(ks.bell_spmm_cuda)
    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", scale=args.scale,
                                       device=args.device)
    calls.clear()  # the training run's calls, as chip_smoke.py counts them
    cm.train(iters=args.iters, warmup=2)
    print(json.dumps({"device": args.device, "scale": args.scale, "iters": args.iters,
                      "strategy": cm.full_graphs[0].strategy,
                      "calls_by_width": dict(sorted(calls.items()))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
