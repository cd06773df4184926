"""The share of the traced job's multi-head attention gradients that ran
on one shared dout block: of the edge-heads (nnz x heads) of its
`gala.attention.grad` counts with more than one head, those whose count
has dout_heads 1 (bwd2's table held the mean's dout once for all heads).
None in a one-head configuration, without a trace, or where no count
carries dout_heads (a program that keeps no such field)."""
from gala_bench import spans


def read(run):
    if int(run.config.get("heads", 1)) <= 1 or run.trace is None:
        return None
    counts = spans.program_counts()
    grads = [c for c in counts or () if c.get("name") == "gala.attention.grad"
             and c.get("heads", 1) > 1]
    if not grads or any("dout_heads" not in c for c in grads):
        return None
    total = sum(c["nnz"] * c["heads"] for c in grads)
    shared = sum(c["nnz"] * c["heads"] for c in grads if c["dout_heads"] == 1)
    return 100.0 * shared / total if total > 0 else None
