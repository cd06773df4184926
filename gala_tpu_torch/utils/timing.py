"""Wall-clock timing of device work (the port of gala_tpu.utils.timing).

PyTorch enqueues CUDA work and returns before the device finishes, so a
timed region is bracketed by `torch.cuda.synchronize()`, once at each
boundary and never inside the region: everything enqueued before the
closing synchronize has run when it returns.  On the CPU there is
nothing to wait for.  Each boundary is the span `gala.fence`
(utils.profiling) under a profiler.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from gala_tpu_torch.utils.profiling import marker


def fence(device) -> None:
    """Wait until all work enqueued on `device` so far is complete."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EpochTimer:
    """Synchronized timing for a region containing many enqueued epochs;
    with `group` (a sharded run's process group) every boundary also
    waits for the group's other ranks (a barrier after the sync)."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        self.t0 = None
        self.seconds = 0.0

    def _fence(self) -> None:
        with marker("gala.fence"):
            fence(self.device)
            if self.group is not None:
                dist.barrier(group=self.group)

    def start(self) -> None:
        self._fence()
        self.t0 = time.perf_counter()

    def stop(self, n: int = 1) -> float:
        """Seconds per epoch over the region (0.0 if it never started)."""
        if self.t0 is None:
            return 0.0
        self._fence()
        self.seconds = time.perf_counter() - self.t0
        self.t0 = None
        return self.seconds / max(n, 1)
