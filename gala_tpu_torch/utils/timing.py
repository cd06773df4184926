"""Wall-clock timing of device work (the port of gala_tpu.utils.timing).

PyTorch enqueues CUDA work and returns before the device finishes, so a
timed region is bracketed by `torch.cuda.synchronize()`, once at each
boundary and never inside the region: everything enqueued before the
closing synchronize has run when it returns.  On the CPU there is
nothing to wait for.
"""
from __future__ import annotations

import time

import torch


def fence(device) -> None:
    """Wait until all work enqueued on `device` so far is complete."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EpochTimer:
    """Synchronized timing for a region containing many enqueued epochs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.t0 = None
        self.seconds = 0.0

    def start(self) -> None:
        fence(self.device)
        self.t0 = time.perf_counter()

    def stop(self, n: int = 1) -> float:
        """Seconds per epoch over the region (0.0 if it never started)."""
        if self.t0 is None:
            return 0.0
        fence(self.device)
        self.seconds = time.perf_counter() - self.t0
        self.t0 = None
        return self.seconds / max(n, 1)
