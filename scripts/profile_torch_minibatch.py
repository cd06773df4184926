#!/usr/bin/env python3
"""Where the time of the port's minibatch GraphSAGE epoch goes, on one
NVIDIA GPU.

    python3 scripts/profile_torch_minibatch.py [--scale 1.0] [--trace mb_trace.json]

Trains gala_tpu_torch.train_minibatch.train_sage_minibatch on the Arxiv
stand-in with gala_tpu's defaults (fanouts 25/10, batch 512, hidden 32)
for one warm-up epoch, then profiles one more epoch (no validation) with
torch.profiler.  Prints the card's name and power limit, the epoch's
timed span (device work, bracketed by synchronizes; the host's sampling
is outside it), the device's busy time and share of that span, device
kernels per batch, the host time of one batch's ops, and the device time
by kernel.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_torch_gat_edge import _device_us, _is_kernel  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="Arxiv")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    from gala_tpu_torch.data.datasets import load_dataset
    from gala_tpu_torch.train_minibatch import train_sage_minibatch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    g, feats, labels, masks = load_dataset(args.dataset, scale=args.scale)
    n_batches = -(-int(masks["train"].sum()) // 512)
    kw = dict(iters=1, valid_step=0, warmup=0, device="cuda")
    train_sage_minibatch(g, feats, labels, masks, **kw)  # cuBLAS, allocator, kernel build
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        res = train_sage_minibatch(g, feats, labels, masks, **kw)
        torch.cuda.synchronize()
    span_us = res.total_time * 1e6
    averages = prof.key_averages()
    events = [e for e in averages if _is_kernel(e) and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in events)
    # host-to-device copies (the validation graph, the feature table, the
    # epoch's indices) all come before the timed span
    copies_us = sum(_device_us(e) for e in events if e.key.startswith("Memcpy HtoD"))
    in_span_us = busy_us - copies_us
    n_kernels = sum(e.count for e in events if not e.key.startswith("Memcpy HtoD"))
    print(f"{smi}; {args.dataset} stand-in at scale {args.scale}: {g.n_rows} nodes, "
          f"{feats.shape[1]} features, {n_batches} batches of 512")
    print(f"epoch span {span_us / 1e3:.3f} ms (under the profiler), "
          f"{span_us / n_batches / 1e3:.3f} ms a batch; device busy {busy_us / 1e3:.3f} ms, of which {copies_us / 1e3:.3f} ms "
          f"host-to-device copies before the span; in the span {in_span_us / 1e3:.3f} ms "
          f"({100 * in_span_us / span_us:.1f}% of it, {in_span_us / n_batches / 1e3:.3f} ms a "
          f"batch); {n_kernels} device kernels, {n_kernels / n_batches:.1f} a batch")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  name")
    for e in events[:25]:
        print(f"{_device_us(e) / 1e3:10.3f} {100 * _device_us(e) / busy_us:5.1f}% "
              f"{e.count:6d}  {e.key[:100]}")
    host = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"{'host ms':>10} {'calls':>6}  op (self CPU time)")
    for e in host[:20]:
        print(f"{e.self_cpu_time_total / 1e3:10.3f} {e.count:6d}  {e.key[:100]}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
