"""Profiling markers and work counters (the port of
gala_tpu.utils.profiling, the LIKWID marker analog).

`profile_trace` records a `torch.profiler` trace of the enclosed block,
host and, where there is a card, device activity (the hand kernels
launched through ctypes appear under their CUDA symbols, as CUPTI
records them), and writes it under `log_dir` as a Chrome trace
(`trace_<pid>_<unique>.json`, viewable in chrome://tracing or Perfetto),
with the block's work counts beside it (`trace_<pid>_<unique>.counts.json`).

`marker`/`annotate` name a region.  While a profiler records they emit a
`torch.profiler.record_function` range, so the region sits in the same
trace as the kernels it launched, on the profiler's clock; otherwise
they return at once: the cost is one test of the profiler's own flag
(`torch.autograd.profiler._is_profiler_enabled`, which every torch
profiler sets while it records).  `marker(name, into=d)` also adds the
block's host seconds to `d[name]` whatever the profiler's state (for
set-up stages, not for per-epoch code).

`count(name, **numbers)` appends one record of the work a region did
(an aggregation's rows, nonzeros, width, ...) to an in-memory list, only
while a profiler records; `counts()` reads it, `clear_counts()` empties
it.  `profile_trace` clears it when it starts.

The port's spans, all named `gala.*`: the lowering's stages
(`gala.lower.*`, lowering.lower, also kept as CompiledModel.lower_spans),
the training job's phases (train.py, utils/timing.py) and the
aggregations' calls and gradients (`gala.spmm`, `gala.spmm.grad`,
`gala.attention`, `gala.attention.grad`), each of which counts its work
under its own name.

gala_tpu's `GALA_TPU_TRACE_DIR` names the default directory for both
packages.  As in gala_tpu the block runs even where the profiler cannot
start; here that, and a trace that recorded no device activity on a
host with a card (no CUPTI), is reported by a warning.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()
_COUNTS: list[dict] = []


def recording() -> bool:
    """Whether a torch profiler is recording now (its own flag)."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, **numbers) -> None:
    """Record the work of one region (`numbers`, e.g. rows, nnz, width)
    under `name`, only while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS.append({"name": name, **numbers})


def counts() -> list[dict]:
    """The records `count` made, in order."""
    return list(_COUNTS)


def clear_counts() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """Capture a torch.profiler trace around the enclosed block and write
    it to `log_dir` (default: $GALA_TPU_TRACE_DIR, else gala_tpu_trace in
    the temporary directory), its work counts beside it; yields `log_dir`.

    with profile_trace("/path/to/traces"):
        cm.train(iters=3)
    """
    log_dir = (log_dir or os.environ.get("GALA_TPU_TRACE_DIR")
               or os.path.join(tempfile.gettempdir(), "gala_tpu_trace"))
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    clear_counts()
    try:
        prof.start()
    except RuntimeError as exc:
        warnings.warn(f"profile_trace: the profiler did not start ({exc}); no trace is "
                      "written", RuntimeWarning, stacklevel=3)
        prof = None
    try:
        yield log_dir
    finally:
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
            fd, path = tempfile.mkstemp(prefix=f"trace_{os.getpid()}_", suffix=".json",
                                        dir=log_dir)
            os.close(fd)
            prof.export_chrome_trace(path)
            with open(path[: -len(".json")] + ".counts.json", "w") as f:
                json.dump(counts(), f)
            if cuda and not any(e.device_type.name == "CUDA" for e in prof.events()):
                warnings.warn("profile_trace: the trace holds no device activity (CUPTI "
                              f"unavailable?): {path}", RuntimeWarning, stacklevel=3)


@contextlib.contextmanager
def _timed(name: str, into: dict):
    """The region under a profiler, and its host seconds added to into[name]."""
    t0 = time.perf_counter()
    with marker(name):
        try:
            yield
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0


def marker(name: str, into: dict | None = None):
    """Named region (LIKWID marker analog): a record_function range while
    a profiler records, else nothing; with `into`, its host seconds are
    added to into[name] in either case."""
    if into is not None:
        return _timed(name, into)
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


def annotate(name: str):
    """Decorator form of `marker`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with marker(name):
                return fn(*a, **k)

        return wrapped

    return deco
