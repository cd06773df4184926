"""The fused attention's share of its roofline over the traced job's own
calls: the work of each `gala.attention` and `gala.attention.grad` count
(gala_bench.work attention_work) bound over the device seconds launched
inside those spans (gala_bench.spans)."""
from gala_bench import spans, work


def read(run):
    return spans.roofline(run, "gala.attention", work.attention_work)
