"""Device ms an epoch of the invariant prefix: the activities launched
inside the program's `gala.prefix` spans in the traced job, over its
epochs (gala_bench.spans)."""
from gala_bench import spans


def read(run):
    return spans.per_epoch_ms(run, "gala.prefix")
