"""The work of GAT's fused aggregation at H heads, counted as the
algorithm must do it, whatever implements it (gala_bench.work counts one
head), and the heads-aware share of the roofline of the traced job's own
attention calls.

Per edge and head: the score (add, leaky ReLU, exp) and an F'-wide
weighted row; per row: x, out and each head's vl, vr, m, s read or
written once.  Peaks and the bound are gala_bench.work's.
"""
from __future__ import annotations

from gala_bench import spans, work


def attention_work(n: int, nnz: int, width: int, heads: int) -> list[tuple[float, float]]:
    """(flops, bytes) of the aggregation and of its gradient, `width` =
    H F' columns in `heads` heads.

    Forward: per edge and head the score (3) and the weighted row (2 F');
    it reads x and each head's vl and vr, and writes out and each head's
    softmax max and sum.  Backward: per edge and head the score again (3),
    the dot of dout[r] with x[c] (2 F') and the weighted row into dx[c]
    (2 F'); it reads dout, x and out, and each head's vl, vr, m, s and
    row dot <dout, out>, and writes dx and each head's dvl and dvr."""
    ids = float(nnz) * work.IDX + (n + 1) * work.IDX
    fwd = (nnz * (2.0 * width + 3.0 * heads), ids + n * (2.0 * width + 4.0 * heads) * work.F32)
    bwd = (nnz * (4.0 * width + 3.0 * heads), ids + n * (4.0 * width + 7.0 * heads) * work.F32)
    return [fwd, bwd]


def job_roofline(run) -> float | None:
    """Percent of the roofline of the traced job's `gala.attention` calls
    and `gala.attention.grad` gradients: each count's bound at its own
    heads, summed, over the device seconds launched inside those spans.
    None in a configuration of one head, without a trace, or where counts
    and spans do not match one to one."""
    if int(run.config.get("heads", 1)) <= 1:
        return None
    job, counts = spans.job_spans(run), spans.program_counts()
    if job is None or counts is None or "gala.attention" not in job.spans:
        return None
    bound = 0.0
    for i, span in enumerate(("gala.attention", "gala.attention.grad")):
        mine = [c for c in counts if c.get("name") == span]
        if len(mine) != job.spans.get(span, 0):
            return None
        bound += sum(work.bound_s(*attention_work(c["rows"], c["nnz"], c["width"],
                                                  c.get("heads", 1))[i]) for c in mine)
    seconds = job.seconds("gala.attention", "gala.attention.grad")
    return 100.0 * bound / seconds if seconds > 0 else None
