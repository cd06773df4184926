"""Sparse-dense matrix multiplication (node aggregation): the port of
gala_tpu.ops.spmm for the 'dense', 'bell', 'ell' and 'segment' strategies.

Semantics:  out[d] = sum over edges e with dst[e]==d of vals[e] * x[src[e]]

- dense: `a_dense @ x` (a plain matrix product, left to torch.matmul as
  gala_tpu left it to XLA).
- bell, ell, segment(_scan): `BellSpmm`, an autograd Function whose
  forward runs the SpMM on the layout and whose backward runs the same op
  on the transpose layout (dx = A^T dz), as gala_tpu's `_spmm_bell`,
  `_spmm_ell` and `_spmm_seg`.  Every layout is read through its row
  descriptors by `ops.kernels.bell_spmm.bell_spmm`: the CUDA kernel on the
  GPU, a plain version on the CPU.

Learned edge values (`spmm_ev`, forward edge order) ride the same
executor as per-slot values (`SlotRows.slot_values`), forward on the
layout and dx on its transpose; their own gradient is the SDDMM
`sddmm_edges(src, dst, x, dz)`, the kernel of ops.kernels.sddmm, skipped
when the values need none (the sparse-rewrite GCN's precomputed
values).
"""
from __future__ import annotations

import torch

from gala_tpu_torch.models.common import full_precision_matmuls
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm, bell_spmm_reference
from gala_tpu_torch.ops.kernels.sddmm import sddmm

__all__ = ["BellSpmm", "bell_spmm_reference", "degrees", "sddmm_edges", "spmm",
           "spmm_direct", "spmm_ev"]


def sddmm_edges(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot product <a[src[e]], b[dst[e]]> (gala_tpu's
    sddmm_edges): the kernel on CUDA tensors, the plain version on CPU."""
    return sddmm(src, dst, a.contiguous(), b.contiguous())


class BellSpmm(torch.autograd.Function):
    """out = A @ x on a row-descriptor layout (`bell`, or an 'ell' or
    'segment' SlotRows); the gradient is A^T @ dz on its transpose."""

    @staticmethod
    def forward(ctx, x, bell, t_bell, n_out: int, c_out: int):
        ctx.t_bell = t_bell
        ctx.c_out = c_out
        return bell_spmm(bell, x, n_out)

    @staticmethod
    def backward(ctx, dz):
        dx = bell_spmm(ctx.t_bell, dz.contiguous(), ctx.c_out)
        return dx, None, None, None, None


class SlotSpmmEv(torch.autograd.Function):
    """out = A(evals) @ x on a SlotRows layout, the values placed in its
    slots by `slot_values` (gala_tpu's `_spmm_ev_ell` / `_spmm_ev_seg`).
    dx runs the same op on the transpose layout, with the values permuted
    into its slots; devals is the SDDMM <x[src], dz[dst]> in forward edge
    order, over the padded edge list."""

    @staticmethod
    def forward(ctx, evals, x, lay, t_lay, src, dst, n_out: int, c_out: int):
        ctx.save_for_backward(evals, x)
        ctx.t_lay, ctx.src, ctx.dst, ctx.c_out = t_lay, src, dst, c_out
        return bell_spmm(lay, x, n_out, vals=lay.slot_values(evals))

    @staticmethod
    def backward(ctx, dz):
        evals, x = ctx.saved_tensors
        dz = dz.contiguous()
        devals = dx = None
        if ctx.needs_input_grad[0]:
            devals = sddmm_edges(ctx.src, ctx.dst, x, dz)
        if ctx.needs_input_grad[1]:
            dx = bell_spmm(ctx.t_lay, dz, ctx.c_out, vals=ctx.t_lay.slot_values(evals))
        return devals, dx, None, None, None, None, None, None


class DenseSpmmEv(torch.autograd.Function):
    """out = A @ x with A (n_pad, c_pad) scattered from the padded edge
    list, A[dst[e], src[e]] += evals[e] (gala_tpu's dense spmm_ev, whose
    padding edges add their values at (phantom row, 0)).  dx = A^T dz;
    devals is the SDDMM, so no N x N gradient is formed."""

    @staticmethod
    def forward(ctx, evals, x, src, dst, n_pad: int, c_pad: int):
        a = torch.zeros(n_pad * c_pad, dtype=x.dtype, device=x.device)
        a.index_add_(0, dst.long() * c_pad + src.long(), evals.to(x.dtype))
        a = a.view(n_pad, c_pad)
        ctx.save_for_backward(a, x)
        ctx.src, ctx.dst = src, dst
        full_precision_matmuls()
        return torch.matmul(a, x)

    @staticmethod
    def backward(ctx, dz):
        a, x = ctx.saved_tensors
        devals = dx = None
        if ctx.needs_input_grad[0]:
            devals = sddmm_edges(ctx.src, ctx.dst, x, dz)
        if ctx.needs_input_grad[1]:
            full_precision_matmuls()
            dx = torch.matmul(a.t(), dz)
        return devals, dx, None, None, None, None


def spmm(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Aggregate node features over the graph: out = A @ x.

    Structural edge values; the gradient flows to `x` only, via the
    transpose layout.  `x` is (c_pad, F); returns (n_pad, F)."""
    if g.strategy == "dense":
        full_precision_matmuls()
        return torch.matmul(g.a_dense, x)
    if g.strategy == "bell":
        return BellSpmm.apply(x, g.bell, g.t_bell, g.n_pad, g.c_pad)
    if g.strategy == "ell":
        return BellSpmm.apply(x, g.ell, g.t_ell, g.n_pad, g.c_pad)
    return BellSpmm.apply(x, g.seg, g.t_seg, g.n_pad, g.c_pad)


def spmm_ev(g: Graph, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Aggregate with learned per-edge values (e_pad,), forward edge order.

    The gradient flows to both `vals` (SDDMM) and `x` (transpose SpMM):
    the autograd contract of gala_tpu's spmm_ev.  On 'bell', whose binned
    layout keeps no slot -> edge permutation, it runs the segment executor
    over the edge lists, as gala_tpu falls back to its segment path."""
    if g.src is None:
        raise ValueError(f"spmm_ev on a {g.strategy!r} graph built without edge lists; "
                         "rebuild with edge_vals=True")
    x = x.contiguous()
    if g.strategy == "dense":
        return DenseSpmmEv.apply(vals, x, g.src, g.dst, g.n_pad, g.c_pad)
    lay, t_lay = (g.ell, g.t_ell) if g.strategy == "ell" else (g.seg, g.t_seg)
    return SlotSpmmEv.apply(vals.contiguous(), x, lay, t_lay, g.src, g.dst, g.n_pad, g.c_pad)


def spmm_direct(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Non-differentiable aggregation (AGGREGATE_MUL_SUM_DIRECT), e.g. the
    degree computation A @ ones used for normalization; always detached."""
    with torch.no_grad():
        return spmm(g, x)


def degrees(g: Graph) -> torch.Tensor:
    """In-degree column vector (n_pad, 1), precomputed at graph build,
    matching SpMM(A, ones) on the padded graph."""
    return g.deg
