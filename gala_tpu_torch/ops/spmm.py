"""Sparse-dense matrix multiplication (node aggregation): the port of
gala_tpu.ops.spmm for the 'dense' and 'bell' strategies.

Semantics:  out[d] = sum over edges e with dst[e]==d of vals[e] * x[src[e]]

- dense: `a_dense @ x` (a plain matrix product, left to torch.matmul as
  gala_tpu left it to XLA).
- bell:  `BellSpmm`, an autograd Function whose forward runs the
  binned-ELL SpMM on the layout and whose backward runs the same op on
  the transpose layout (dx = A^T dz), as gala_tpu's `_spmm_bell`.  Both
  directions go through `ops.kernels.bell_spmm.bell_spmm`: the CUDA
  kernel on the GPU, `bell_spmm_reference` on the CPU.
"""
from __future__ import annotations

import torch

from gala_tpu_torch.models.common import full_precision_matmuls
from gala_tpu_torch.ops.graph import Graph, not_ported
from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm, bell_spmm_reference

__all__ = ["BellSpmm", "bell_spmm_reference", "degrees", "spmm", "spmm_direct"]


class BellSpmm(torch.autograd.Function):
    """out = A @ x on `bell`; the gradient is A^T @ dz on `t_bell`."""

    @staticmethod
    def forward(ctx, x, bell, t_bell, n_out: int, c_out: int):
        ctx.t_bell = t_bell
        ctx.c_out = c_out
        return bell_spmm(bell, x, n_out)

    @staticmethod
    def backward(ctx, dz):
        dx = bell_spmm(ctx.t_bell, dz.contiguous(), ctx.c_out)
        return dx, None, None, None, None


def spmm(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Aggregate node features over the graph: out = A @ x.

    Structural edge values; the gradient flows to `x` only, via the
    transpose layout.  `x` is (c_pad, F); returns (n_pad, F)."""
    if g.strategy == "dense":
        full_precision_matmuls()
        return torch.matmul(g.a_dense, x)
    if g.strategy == "bell":
        return BellSpmm.apply(x, g.bell, g.t_bell, g.n_pad, g.c_pad)
    raise not_ported(f"spmm on strategy {g.strategy!r}", "ROADMAP Queue 1 item 7")


def spmm_direct(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Non-differentiable aggregation (AGGREGATE_MUL_SUM_DIRECT), e.g. the
    degree computation A @ ones used for normalization; always detached."""
    with torch.no_grad():
        return spmm(g, x)


def degrees(g: Graph) -> torch.Tensor:
    """In-degree column vector (n_pad, 1), precomputed at graph build,
    matching SpMM(A, ones) on the padded graph."""
    return g.deg
