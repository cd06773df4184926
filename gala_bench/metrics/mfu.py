"""Model FLOPs of the window's jobs over the window's seconds, as a share
of the card's float32 peak (gala_bench.work)."""
from gala_bench import work


def read(run):
    if run.device.type != "cuda" or not run.jobs:
        return None
    return 100.0 * run.job_flops() * run.jobs / (run.window_s * work.PEAK_FLOPS_F32)
