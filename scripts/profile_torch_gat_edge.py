#!/usr/bin/env python3
"""Where the time of the port's unfused GAT training goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_gat_edge.py [--epochs 10] [--trace gat_edge_trace.json]

Compiles __graft_entry__.GAT_DSL with the attention_fusion pass off (the
edge-valued chain: SDDVV-add, leaky ReLU, edge softmax, SpMM with edge
values, and the SDDMM in its backward) on the Arxiv stand-in (scale 1.0,
strategy auto -> ell) with gala_tpu_torch, and profiles one `train()`
call with torch.profiler (`profile_train`, which
scripts/profile_torch_minibatch.py shares).
Then times, with CUDA events at the path's widths (F 32 and 40), the
SpMM kernel with per-slot values on the ELL layout and its transpose (all
rows, rows of at most 128 slots, longer rows alone) and the SDDMM kernel
against its plain version.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_LONG_ROW = 128  # slots: the binned layout's hub threshold (data.ell.BIN_SIZES[-1])


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
    from __graft_entry__ import GAT_DSL
    from gala_tpu_torch.dsl.parser import parse_source

    spec = parse_source(GAT_DSL)
    spec.passes.attention_fusion = False
    cm = gala_tpu_torch.compile_model(spec, mode="train", scale=1.0, device="cuda")
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
