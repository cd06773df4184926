"""Device ms an epoch of the deferred test evaluation: the activities
launched inside the program's `gala.test_eval` span in the traced job,
over its epochs (gala_bench.spans)."""
from gala_bench import spans


def read(run):
    return spans.per_epoch_ms(run, "gala.test_eval")
