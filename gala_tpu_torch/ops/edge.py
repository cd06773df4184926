"""Edge-level operations: SDDVV, SDDMM, edge softmax (the port of
gala_tpu.ops.edge).

The unfused GAT chain (SDDVV-add logits, leaky ReLU, edge softmax, then
ops.spmm.spmm_ev) and the sparse-rewrite precompute (SDDVV-mul).  All
edge tensors are (e_pad,) in forward (dst-sorted) edge order, padding
edges included: their src is 0 and their dst the phantom row, which
forms its own softmax segment, as in gala_tpu.

gala_tpu runs these ops outside Pallas, and so does the port: plain
PyTorch, with gathers by the int32 edge lists and per-destination
reductions by `torch.segment_reduce` over the destination segments'
lengths (`g.seg.row_len`, one per padded node).  The one kernel behind
this module is the SDDMM's (ops.kernels.sddmm).
"""
from __future__ import annotations

import torch

from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.spmm import sddmm_edges


def sddvv_add(g: Graph, vl: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    """Per-edge sum of node scalars: e -> vl[src[e]] + vr[dst[e]] (the GAT
    attention logits).  vl is (c_pad, 1), vr (n_pad, 1); returns (e_pad,).
    Differentiable through the gathers (their backward scatter-adds).  On
    a rank's ShardGraph the sharded form (parallel.ops)."""
    if g.strategy == "spmd":
        from gala_tpu_torch.parallel.ops import spmd_sddvv_add

        return spmd_sddvv_add(g.src, g.dst_local, vl, vr, g.rows_per_shard, g.group)
    return vl[:, 0].index_select(0, g.src) + vr[:, 0].index_select(0, g.dst)


def sddvv_mul(g: Graph, vl: torch.Tensor, vr: torch.Tensor) -> torch.Tensor:
    """Per-edge product of node scalars: e -> vl[src[e]] * vr[dst[e]] (the
    sparsity-aware rewrite's norm_src * norm_dst edge values)."""
    if g.strategy == "spmd":
        from gala_tpu_torch.parallel.ops import spmd_sddvv_mul

        return spmd_sddvv_mul(g.src, g.dst_local, vl, vr, g.rows_per_shard, g.group)
    return vl[:, 0].index_select(0, g.src) * vr[:, 0].index_select(0, g.dst)


class _Sddmm(torch.autograd.Function):
    """<a[src[e]], b[dst[e]]> with gala_tpu's gradient (autodiff of its
    gathers): da scatter-adds gout * b[dst] by source, db gout * a[src]
    by destination, over every padded edge.  No production path
    differentiates an SDDMM (spmm_ev's backward calls the forward only),
    so the backward is plain PyTorch."""

    @staticmethod
    def forward(ctx, a, b, src, dst):
        ctx.save_for_backward(a, b, src, dst)
        return sddmm_edges(src, dst, a, b)

    @staticmethod
    def backward(ctx, gout):
        a, b, src, dst = ctx.saved_tensors
        g = gout.unsqueeze(1)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.zeros_like(a).index_add_(0, src, g * b.index_select(0, dst))
        if ctx.needs_input_grad[1]:
            db = torch.zeros_like(b).index_add_(0, dst, g * a.index_select(0, src))
        return da, db, None, None


def sddmm(g: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product: e -> <a[src[e]], b[dst[e]]>, a (c_pad, F),
    b (n_pad, F); returns (e_pad,).  The SDDMM kernel on CUDA tensors."""
    return _Sddmm.apply(a, b, g.src, g.dst)


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


# --------------------------------------------------------------------------- #
# edge softmax: softmax over each destination's incoming-edge segment
# --------------------------------------------------------------------------- #
def _segment_sum(v: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(v, "sum", lengths=lengths, unsafe=True)


def _segment_softmax(logits: torch.Tensor, dst: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    m = torch.segment_reduce(logits, "max", lengths=lengths, unsafe=True)
    # empty segments produce a -inf max; make it safe
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = torch.exp(logits - m.index_select(0, dst))
    s = _segment_sum(z, lengths)
    s = torch.where(s > 0, s, torch.ones_like(s))
    return z / s.index_select(0, dst)


class _EdgeSoftmax(torch.autograd.Function):
    """p = per-destination softmax of the logits; the backward is
    gala_tpu's dlogits = p * (dp - segment_sum(p * dp)[dst]) from the
    saved p."""

    @staticmethod
    def forward(ctx, logits, dst, lengths):
        p = _segment_softmax(logits, dst, lengths)
        ctx.save_for_backward(p, dst, lengths)
        return p

    @staticmethod
    def backward(ctx, dp):
        p, dst, lengths = ctx.saved_tensors
        sds = _segment_sum(p * dp, lengths)
        return p * (dp - sds.index_select(0, dst)), None, None


def edge_softmax(g: Graph, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of edge logits (e_pad,) over each destination's incoming
    edges.  The padding edges form the phantom row's segment and do not
    affect real nodes.  Segment sums run in another order than
    gala_tpu's.  On a rank's ShardGraph the sharded form, masked by
    occupancy."""
    if g.strategy == "spmd":
        from gala_tpu_torch.parallel.ops import spmd_edge_softmax

        return spmd_edge_softmax(g.dst_local, logits, g.occ, g.rows_per_shard)
    return _EdgeSoftmax.apply(logits.contiguous(), g.dst, g.seg.row_len)


def mask_padded_edges(g: Graph, evals: torch.Tensor) -> torch.Tensor:
    """Zero out phantom-edge entries of a per-edge vector."""
    e_idx = torch.arange(g.e_pad, device=evals.device)
    return torch.where(e_idx < g.n_edges, evals, torch.zeros_like(evals))
