"""Device ms an epoch of the GAT-form heads' own ops: the activities
launched inside the program's `gala.head_scores`, `gala.head_mean` and
`gala.elu` spans (their forwards) in the traced job, over its epochs
(gala_bench.spans).  None where the program has none of them."""
from gala_bench import spans

NAMES = ("gala.head_scores", "gala.head_mean", "gala.elu")


def read(run):
    job = spans.job_spans(run)
    if job is None or not any(name in job.spans for name in NAMES):
        return None
    return 1e3 * job.seconds(*NAMES) / run.iters
