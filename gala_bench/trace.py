"""One job under torch.profiler, reduced to what the per-layer readers
need: device activity (kernels, copies, memsets) inside the job's span,
its union, the time by device operation, and the idle gaps named by the
host operation that ran during each.
"""
from __future__ import annotations

import dataclasses
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN = "gala_bench.job"
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    activities: int
    device_ops: list    # [[name, seconds], ...] most time first
    idle_gaps: list     # [[host op, seconds], ...] most idle time first
    kernel_s: dict      # kernel name -> seconds


def profile_job(run_job, out_path: str) -> TraceSummary | None:
    """Run `run_job()` once under the profiler, write its Chrome trace to
    `out_path` and reduce it.  None when the trace holds no device
    activity (no card, or a profiler that cannot trace it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            run_job()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    prof.export_chrome_trace(out_path)
    with open(out_path) as f:
        events = json.load(f)["traceEvents"]
    return summarize(events)


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(events: list) -> TraceSummary | None:
    """Reduce Chrome-trace events (times in microseconds)."""
    spans = [e for e in events if e.get("name") == SPAN and e.get("ph") == "X"]
    if not spans:
        return None
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    if not dev:
        return None
    merged = _merged(dev)
    busy = sum(b - a for a, b in merged)
    host = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
         for e in events
         if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") != SPAN),
        key=lambda t: t[0])
    gaps, active, nxt = {}, [], 0
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)  # gaps come in time order: sweep the host ops
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        # the innermost host op covering the gap's middle: the latest start
        name = max(active, key=lambda h: h[0])[2] if active else "host idle"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy * 1e-6,
        activities=len(dev),
        device_ops=[[k, v] for k, v in top[:TOP]],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        kernel_s=dict(top),
    )
