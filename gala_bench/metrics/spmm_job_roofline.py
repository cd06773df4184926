"""The SpMM's share of its roofline over the traced job's own calls:
the work of each `gala.spmm` and `gala.spmm.grad` count (gala_bench.work
spmm_work, from the program's real rows, nonzeros and widths) bound over
the device seconds launched inside those spans (gala_bench.spans)."""
from gala_bench import spans, work


def read(run):
    return spans.roofline(run, "gala.spmm", work.spmm_work)
