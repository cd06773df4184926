"""The work a cell needs, counted from the benchmark's own CSR and the
configuration's widths, never from the port's layouts: what an
algorithm must read, write and compute, whatever implements it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity): the
port runs float32 with TF32 off, outside the tensor cores.
"""
from __future__ import annotations

PEAK_FLOPS_F32 = 67e12   # float32 FMA, TF32 off
PEAK_BYTES = 3.35e12     # HBM3
F32 = 4
IDX = 4                  # one int32 id or offset


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take."""
    return max(flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES)


def spmm_work(n: int, nnz: int, width: int) -> list[tuple[float, float]]:
    """(flops, bytes) of A @ x and of its gradient A^T @ dout, structural
    edge values: a source id per edge, the row offsets, the input rows
    read once and the output rows written once, one add per edge and
    column."""
    one = (float(nnz) * width,
           float(nnz) * IDX + (n + 1) * IDX + 2.0 * n * width * F32)
    return [one, one]


def attention_work(n: int, nnz: int, width: int) -> list[tuple[float, float]]:
    """(flops, bytes) of GAT's aggregation and of its gradient (one head).

    Forward: per edge the score (add, leaky ReLU, exp) and the weighted
    sum of a width-wide row; it reads x, vl, vr and writes out and the
    softmax's per-row max and sum.  Backward: per edge the score again,
    the dot of dout[r] with x[c] and the weighted row into dx[c]; it
    reads dout, x, vl, vr, out and the two statistics and writes dx, dvl
    and dvr."""
    ids = float(nnz) * IDX + (n + 1) * IDX
    fwd = (nnz * (2.0 * width + 3), ids + n * (2.0 * width + 4) * F32)
    bwd = (nnz * (4.0 * width + 3), ids + n * (4.0 * width + 7) * F32)
    return [fwd, bwd]


def roofline_pct(work: list[tuple[float, float]], seconds: float) -> float:
    """Share of the roofline reached: the sum of the calls' bounds over
    their measured time, in percent."""
    return 100.0 * sum(bound_s(f, b) for f, b in work) / seconds


def model_flops_per_job(model: str, n: int, feats: int, hidden: int, classes: int,
                        nnz_full: int, nnz_sub: list[int], iters: int,
                        valid_step: int) -> float:
    """Model FLOPs of one training job of GALA's protocol.

    An epoch is a training step (3 forwards) and an inference epoch (1
    forward) on one graph set: the full graph every valid_step-th epoch,
    the per-layer training subgraphs (nnz_sub) otherwise; each
    validation epoch adds a test forward on the full graph.  Dense layers
    count 2 n d_in d_out; an aggregation counts 2 nnz min(d_in, d_out)
    (the narrower side is where it is cheapest); GAT's scores add 4 per
    edge (add, leaky ReLU, exp, divide).  GCN's first aggregation reads
    only the features: it is training invariant and counts once per graph
    set a job uses, so no hoisting or reordering can lift a reading
    past the peak."""
    dims = [(feats, hidden), (hidden, classes)]
    dense = sum(2.0 * n * i * o for i, o in dims)

    def forward(edges: list[int]) -> float:
        agg = 0.0
        for li, ((i, o), e) in enumerate(zip(dims, edges)):
            if model == "gcn" and li == 0:
                continue
            agg += 2.0 * e * min(i, o)
            if model == "gat":
                agg += 2.0 * n * o * 2 + 4.0 * e
        return dense + agg

    full, sub = [nnz_full] * len(dims), list(nnz_sub)
    n_valid = len([e for e in range(iters) if e % valid_step == 0])
    n_sub = iters - n_valid
    total = (3 + 1 + 1) * n_valid * forward(full) + (3 + 1) * n_sub * forward(sub)
    if model == "gcn":
        prefix_width = min(dims[0])
        total += 2.0 * nnz_full * prefix_width
        if n_sub:
            total += 2.0 * nnz_sub[0] * prefix_width
    return total
