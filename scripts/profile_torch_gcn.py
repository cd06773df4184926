#!/usr/bin/env python3
"""Where the time of the port's GCN training goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_gcn.py [--epochs 10] [--trace gcn_trace.json]

Compiles __graft_entry__.GCN_DSL on the Arxiv stand-in (scale 1.0) with
gala_tpu_torch, warms up with one short training run, then profiles one
`train()` call (training phase, inference phase and the accuracy
evaluations) with torch.profiler.  Prints the device time by kernel, the
device's busy share of the profiled wall time, the card's name and power
limit.  Then times the bell SpMM kernel on the full layout at F = 1, 32
and 128 with CUDA events, on all rows, on the degree-bin rows alone and
on the hub rows alone.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _is_kernel(evt) -> bool:
    """Device-side events (kernels, memsets, copies).  The CPU-side op
    ranges above them, and annotated ranges mirrored onto the device
    timeline (e.g. Optimizer.step), carry the same time again."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--trace", default="", help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")

    import gala_tpu_torch
    from __graft_entry__ import GCN_DSL

    cm = gala_tpu_torch.compile_source(GCN_DSL, mode="train", scale=1.0, device="cuda")
    profile_train(cm, args.epochs, args.trace)
    split_kernel_time(cm.full_graphs[0])
    return 0


def profile_train(cm, epochs: int, trace: str = "") -> None:
    """Warm up with one short training run, then profile one `train()`
    call of `epochs` epochs with torch.profiler; print the card's name and
    power limit, the device's busy share of the profiled wall time and
    the device time by kernel; write a Chrome trace to `trace` if given."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cm.train(iters=3, warmup=1)  # cuBLAS, allocator and kernel build warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        res = cm.train(iters=epochs, warmup=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if _is_kernel(e) and _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in events)
    print(f"{smi}; {epochs} epochs; csv {res.csv(print_accuracy=True)}")
    print(f"profiled wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%)")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  name")
    for e in events[:25]:
        print(f"{_device_us(e) / 1e3:10.3f} {100 * _device_us(e) / busy_us:5.1f}% "
              f"{e.count:6d}  {e.key[:100]}")
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)


def _cuda_ms(fn, reps: int = 20) -> float:
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


def split_kernel_time(g) -> None:
    """Kernel time on all rows, bin rows only and hub rows only (the hub
    rows are the last n_big row descriptors)."""
    from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm

    b = g.bell
    nb = b.n_real - b.n_big
    parts = {
        "all rows": b,
        "bin rows": dataclasses.replace(b, row_start=b.row_start[:nb], row_len=b.row_len[:nb],
                                        row_node=b.row_node[:nb], diag=None),
        "hub rows": dataclasses.replace(b, row_start=b.row_start[nb:], row_len=b.row_len[nb:],
                                        row_node=b.row_node[nb:], diag=None),
    }
    hub_len = b.row_len[nb:]
    print(f"bell layout: {b.n_big} hub rows with {int(hub_len.sum())} slots (longest "
          f"{int(hub_len.max()) if b.n_big else 0}), {int(b.row_len[:nb].sum())} bin-row slots")
    for f in (1, 32, 128):
        x = torch.randn((g.c_pad, f), device="cuda")
        times = ", ".join(f"{name} {_cuda_ms(lambda lay=lay: bell_spmm(lay, x, g.n_pad)):.4f} ms"
                          for name, lay in parts.items())
        print(f"bell_spmm F={f}: {times}")


if __name__ == "__main__":
    sys.exit(main())
