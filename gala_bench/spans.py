"""The program's own spans and work counts in the traced job.

gala_tpu_torch names its regions `gala.*` (utils.profiling.marker): the
job's phases, each aggregation call and its gradient.  Under the
profiler they are `user_annotation` events of the Chrome trace that
trace.profile_job writes (`_trace/<cell>.json`), and each aggregation
span counts its work (`utils.profiling.count`).

A device activity (kernel, copy, memset) belongs to a span by its
launch, not by its time on the device, which runs behind the host: the
runtime call with the activity's `correlation` id is found, and the
activity's device seconds count towards every `gala.*` span of that
call's process whose host interval holds the call, once per span name
(inclusive).  A span on the call's own thread holds it as nesting does;
one on another thread holds it while that thread waits inside the span:
the autograd engine launches a backward's kernels on its own thread
while the caller waits in `gala.backward`.
"""
from __future__ import annotations

import dataclasses
import json
import os

from gala_bench import trace, work

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX = "gala."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class JobSpans:
    spans: dict         # span name -> number of spans
    activities: list    # [(device seconds, frozenset of span names)]

    def seconds(self, *names: str) -> float:
        """Device seconds of the activities launched inside any of `names`."""
        want = set(names)
        return sum(s for s, held in self.activities if held & want)


def attribute(events: list) -> JobSpans:
    """Attribute the trace's device activities to its `gala.*` spans."""
    spans, calls = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            spans.setdefault(e.get("pid"), []).append((ts, end, e["name"]))
        elif cat in RUNTIME_CATS and "correlation" in e.get("args", {}):
            calls[e["args"]["correlation"]] = (e.get("pid"), ts, end)
    launched = {}   # pid -> [(call start, call end, device seconds)]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is not None:
            launched.setdefault(call[0], []).append(
                (call[1], call[2], float(e.get("dur", 0.0)) * 1e-6))
    activities = []
    for pid, acts in launched.items():
        opened = sorted(spans.get(pid, []))
        active, nxt = [], 0
        for a, b, sec in sorted(acts):
            while nxt < len(opened) and opened[nxt][0] <= a:
                active.append(opened[nxt])
                nxt += 1
            active = [s for s in active if s[1] >= a]
            activities.append((sec, frozenset(s[2] for s in active if s[1] >= b)))
    counted = {}
    for pid_spans in spans.values():
        for *_, name in pid_spans:
            counted[name] = counted.get(name, 0) + 1
    return JobSpans(spans=counted, activities=activities)


_CACHE: dict = {}


def job_spans(run) -> JobSpans | None:
    """The traced job's spans, or None without a trace of this run."""
    if run.trace is None:
        return None
    path = os.path.join(HERE, "_trace", f"{run.cell.name}.json")
    if not os.path.exists(path):
        return None
    key = (path, os.path.getmtime(path))
    if key not in _CACHE:
        with open(path) as f:
            _CACHE.clear()
            _CACHE[key] = attribute(json.load(f)["traceEvents"])
    return _CACHE[key]


def per_epoch_ms(run, name: str) -> float | None:
    """Device ms an epoch of the activities launched inside `name`."""
    job = job_spans(run)
    if job is None or name not in job.spans:
        return None
    return 1e3 * job.seconds(name) / run.iters


def program_counts() -> list | None:
    """The program's work counts of the traced job (None where the
    program keeps none)."""
    from gala_tpu_torch.utils import profiling

    read = getattr(profiling, "counts", None)
    return read() if read is not None else None


def roofline(run, name: str, work_of) -> float | None:
    """Share of the roofline of the job's `name` calls and `name`.grad
    gradients: their work (work_of(rows, nnz, width) -> [forward,
    gradient]) bound over the device seconds launched inside them."""
    job, counts = job_spans(run), program_counts()
    if job is None or counts is None or name not in job.spans:
        return None
    bound = 0.0
    for i, span in enumerate((name, name + ".grad")):
        mine = [c for c in counts if c.get("name") == span]
        if len(mine) != job.spans.get(span, 0):
            return None
        bound += sum(work.bound_s(*work_of(c["rows"], c["nnz"], c["width"])[i]) for c in mine)
    seconds = job.seconds(name, name + ".grad")
    return 100.0 * bound / seconds if seconds > 0 else None


def lower_stage_s(run, name: str) -> float | None:
    """Host seconds of one lowering stage (CompiledModel.lower_spans)."""
    stages = getattr(run.cm, "lower_spans", None) or {}
    return stages.get(name)
