"""The fused attention's share of its roofline at its heads, over the
traced job's own calls: the work of each `gala.attention` and
`gala.attention.grad` count at the count's heads (gala_bench.heads_work)
bound over the device seconds launched inside those spans
(gala_bench.spans).  None in a one-head configuration."""
from gala_bench import heads_work


def read(run):
    return heads_work.job_roofline(run)
