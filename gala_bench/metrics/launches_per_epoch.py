"""Device activities (kernels, memsets, copies) in the profiled job,
over its epochs."""


def read(run):
    return run.trace.activities / run.iters if run.trace else None
