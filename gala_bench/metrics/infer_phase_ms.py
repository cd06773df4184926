"""The program's own mean inference-phase ms per epoch over the window's
jobs (TrainResult.inference_time)."""
import statistics


def read(run):
    return 1e3 * statistics.fmean(run.infer_phase_s) if run.infer_phase_s else None
