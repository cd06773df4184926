"""Profiling markers (the port of gala_tpu.utils.profiling, the LIKWID
marker analog).

`profile_trace` records a `torch.profiler` trace of the enclosed block,
host and, where there is a card, device activity (the hand kernels
launched through ctypes appear under their CUDA symbols, as CUPTI
records them), and writes it under `log_dir` as a Chrome trace
(`trace_<pid>_<unique>.json`, viewable in chrome://tracing or Perfetto).
`marker`/`annotate` name a region (`torch.profiler.record_function`);
outside a trace they cost a context manager and record nothing.

gala_tpu's `GALA_TPU_TRACE_DIR` names the default directory for both
packages.  As in gala_tpu the block runs even where the profiler cannot
start; here that, and a trace that recorded no device activity on a
host with a card (no CUPTI), is reported by a warning.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import warnings

import torch
from torch.profiler import ProfilerActivity, profile, record_function

@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """Capture a torch.profiler trace around the enclosed block and write
    it to `log_dir` (default: $GALA_TPU_TRACE_DIR, else gala_tpu_trace in
    the temporary directory); yields `log_dir`.

    with profile_trace("/path/to/traces"):
        cm.train(iters=3)
    """
    log_dir = (log_dir or os.environ.get("GALA_TPU_TRACE_DIR")
               or os.path.join(tempfile.gettempdir(), "gala_tpu_trace"))
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
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
            if cuda and not any(e.device_type.name == "CUDA" for e in prof.events()):
                warnings.warn("profile_trace: the trace holds no device activity (CUPTI "
                              f"unavailable?): {path}", RuntimeWarning, stacklevel=3)


@contextlib.contextmanager
def marker(name: str):
    """Named region annotation (LIKWID marker analog; shows up in traces)."""
    with record_function(name):
        yield


def annotate(name: str):
    """Decorator form of `marker`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with marker(name):
                return fn(*a, **k)

        return wrapped

    return deco
