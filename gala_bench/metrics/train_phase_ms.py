"""The program's own mean training-phase ms per epoch over the window's
jobs (TrainResult.total_time)."""
import statistics


def read(run):
    return 1e3 * statistics.fmean(run.train_phase_s) if run.train_phase_s else None
