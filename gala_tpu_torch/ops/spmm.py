"""Sparse-dense matrix multiplication (node aggregation): the port of
gala_tpu.ops.spmm for the 'dense', 'bell', 'ell' and 'segment' strategies.

Semantics:  out[d] = sum over edges e with dst[e]==d of vals[e] * x[src[e]]

- dense: `a_dense @ x` (a plain matrix product, left to torch.matmul as
  gala_tpu left it to XLA).
- bell, ell, segment(_scan): the custom op `gala_tpu_torch::bell_spmm`
  (ops.kernels.library), whose forward runs the SpMM on the layout and
  whose registered gradient runs the same op on the transpose layout
  (dx = A^T dz), as gala_tpu's `_spmm_bell`, `_spmm_ell` and `_spmm_seg`.
  Every layout is read through its row descriptors by the kernel of
  ops.kernels.bell_spmm on the GPU, its plain version on the CPU.

Dynamic neighbor sampling (`spmm_sampled`, gala_tpu's spmm_sampled): k
picks (ra*i + rb) mod deg per row, summed with repetition, are the row's
aggregation with per-slot weights w(deg, pos) (ops.kernels.dyn_weights),
so `SampledSpmm` runs the SpMM kernel's sampled form
(ops.kernels.bell_spmm.bell_spmm_sampled), which computes each slot's
weight where it stages the slot's value: one launch a product, no
weights tensor.  On 'bell' the weights multiply the structural values
(gala_tpu's _spmm_dyn_bell), on every other strategy the edge-list
layouts take them alone, value 1 a pick (its _spmm_dyn); the backward
re-samples the transpose rows with the same (ra, rb).  No per-epoch
index gather.

Learned edge values (`spmm_ev`, forward edge order; the custom op
`gala_tpu_torch::spmm_ev`) ride the same executor as per-slot values
(`SlotRows.slot_values`), forward on the layout and dx on its transpose;
their own gradient is the SDDMM `sddmm_edges(src, dst, x, dz)`, the op
`gala_tpu_torch::sddmm` (the kernel of ops.kernels.sddmm), skipped when
the values need none (the sparse-rewrite GCN's precomputed values).

On a rank's ShardGraph (strategy 'spmd', gala_tpu_torch.parallel) the
aggregations dispatch to the sharded forms of parallel.ops; its
learned-value form on the rank's binned layouts is `BellSpmmEv`
(gala_tpu's _spmm_ev_bell, which only the sharded path calls): the
values placed into the bell layout's slots through its slot -> edge
map, the SpMM kernel forward and on the transpose, the SDDMM kernel over
the slots for the values' gradient.  Dynamic sampling is single-device.

bf16 activations (gala_tpu's dtype=jnp.bfloat16): x bf16, the output
bf16.  The kernels read bf16 tables and accumulate in f32; structural and
learned values are f32 (a learned bf16 value upcast exactly) and rounded
to bf16 in the product, as gala_tpu's vals.astype(x.dtype).  'dense'
follows gala_tpu's jnp.dot(f32 A, bf16 x, preferred_element_type=x.dtype):
the product in f32, the result rounded to x's dtype.

Under a profiler (utils.profiling) `spmm` is the span `gala.spmm`, on
every strategy, and counts its work under that name: the graph's real
rows and nonzeros (Graph.n_nodes, n_edges), x's width and item size.
The custom op's gradient is the span `gala.spmm.grad`, counted with the
transpose's rows (ops.kernels.library).  A rank's ShardGraph counts
nothing.
"""
from __future__ import annotations

import torch

from gala_tpu_torch.models.common import full_precision_matmuls
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.kernels import library
from gala_tpu_torch.ops.kernels.bell_spmm import bell_spmm_reference, bell_spmm_sampled
from gala_tpu_torch.ops.kernels.library import sddmm_edges
from gala_tpu_torch.utils.profiling import count, marker, recording

__all__ = ["BellSpmmEv", "SampledSpmm", "bell_spmm_reference", "degrees", "sddmm_edges",
           "spmm", "spmm_direct", "spmm_ev", "spmm_ev_bell", "spmm_sampled"]


class SampledSpmm(torch.autograd.Function):
    """out = A_s @ x, A_s the layout with this epoch's sampling weights as
    its slot values (times its structural values where `structural`);
    the gradient is the transpose layout under its own weights, the same
    (k, ra, rb)."""

    @staticmethod
    def forward(ctx, x, lay, t_lay, meta, t_meta, structural: bool, k: int, ra: int, rb: int,
                n_out: int, c_out: int):
        ctx.t_lay, ctx.t_meta, ctx.c_out = t_lay, t_meta, c_out
        ctx.sample = (k, ra, rb, structural)
        return bell_spmm_sampled(lay, x, n_out, meta, k, ra, rb, structural)

    @staticmethod
    def backward(ctx, dz):
        return (bell_spmm_sampled(ctx.t_lay, dz.contiguous(), ctx.c_out, ctx.t_meta,
                                  *ctx.sample),) + (None,) * 10


class DenseSpmmEv(torch.autograd.Function):
    """out = A @ x with A (n_pad, c_pad) scattered from the padded edge
    list, A[dst[e], src[e]] += evals[e] (gala_tpu's dense spmm_ev, whose
    padding edges add their values at (phantom row, 0)).  dx = A^T dz;
    devals is the SDDMM, so no N x N gradient is formed.  A takes x's
    dtype, as gala_tpu's."""

    @staticmethod
    def forward(ctx, evals, x, src, dst, n_pad: int, c_pad: int):
        a = torch.zeros(n_pad * c_pad, dtype=x.dtype, device=x.device)
        a.index_add_(0, dst.long() * c_pad + src.long(), evals.to(x.dtype))
        a = a.view(n_pad, c_pad)
        ctx.save_for_backward(a, x)
        ctx.src, ctx.dst, ctx.evals_dtype = src, dst, evals.dtype
        full_precision_matmuls()
        return torch.matmul(a, x)

    @staticmethod
    def backward(ctx, dz):
        a, x = ctx.saved_tensors
        devals = dx = None
        if ctx.needs_input_grad[0]:
            devals = sddmm_edges(ctx.src, ctx.dst, x, dz).to(ctx.evals_dtype)
        if ctx.needs_input_grad[1]:
            full_precision_matmuls()
            dx = torch.matmul(a.t(), dz)
        return devals, dx, None, None, None, None


class BellSpmmEv(torch.autograd.Function):
    """out = A(evals) @ x on a binned layout (gala_tpu's _spmm_ev_bell, the
    sharded path's learned-value SpMM): slot values [evals | 0][edge_perm]
    into the SpMM kernel's per-slot input; dx the kernel on the transpose
    layout with [evals | 0][t_edge_perm]; devals the per-slot products
    <x[slot_src], dz[slot_dst]> by the SDDMM kernel over the forward
    slots, back to edges as [dslot | 0][slot_of_edge].  Pad slots read
    the appended zero value, edges outside the layout the appended zero
    slot.  `ev`: parallel.graph.SlotEdges."""

    @staticmethod
    def forward(ctx, evals, x, bell, t_bell, ev, n_out: int, c_out: int):
        ev_pad = torch.cat([evals.float(), evals.new_zeros(1, dtype=torch.float32)])
        ctx.save_for_backward(evals, x, ev_pad)
        ctx.args = (t_bell, ev, c_out)
        return library.bell_spmm_op(x, *library.layout_args(bell),
                                    ev_pad.index_select(0, ev.edge_perm), n_out, [], [], 0)

    @staticmethod
    def backward(ctx, dz):
        evals, x, ev_pad = ctx.saved_tensors
        t_bell, ev, c_out = ctx.args
        dz = dz.contiguous()
        devals = dx = None
        if ctx.needs_input_grad[0]:
            dslot = sddmm_edges(ev.slot_src, ev.slot_dst, x, dz)
            devals = torch.cat([dslot, dslot.new_zeros(1)]).index_select(
                0, ev.slot_of_edge).to(evals.dtype)
        if ctx.needs_input_grad[1]:
            dx = library.bell_spmm_op(dz, *library.layout_args(t_bell),
                                      ev_pad.index_select(0, ev.t_edge_perm), c_out, [], [], 0)
        return devals, dx, None, None, None, None, None


def spmm_ev_bell(evals: torch.Tensor, x: torch.Tensor, bell, t_bell, ev, n_out: int,
                 c_out: int) -> torch.Tensor:
    """Learned-value SpMM on a binned layout and its transpose (BellSpmmEv);
    differentiable in evals and x."""
    return BellSpmmEv.apply(evals, x.contiguous(), bell, t_bell, ev, n_out, c_out)


def _spmd(op: str, *args):
    """The sharded form of an aggregation (parallel.ops), for a rank's
    ShardGraph."""
    from gala_tpu_torch.parallel import ops

    return getattr(ops, op)(*args)


def spmm(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Aggregate node features over the graph: out = A @ x.

    Structural edge values; the gradient flows to `x` only, via the
    transpose layout.  `x` is (c_pad, F); returns (n_pad, F).  On a rank's
    ShardGraph (strategy 'spmd') the sharded form: the bell layouts, else
    the halo exchange, else the all_gather."""
    with marker("gala.spmm"):
        grad_work = None
        if recording() and g.strategy != "spmd":
            width, itemsize = int(x.shape[1]), x.element_size()
            count("gala.spmm", rows=g.n_nodes, nnz=g.n_edges, width=width, heads=1,
                  itemsize=itemsize)
            grad_work = {"rows": g.n_cols, "nnz": g.n_edges, "width": width, "heads": 1,
                         "itemsize": itemsize}
        if g.strategy == "spmd":
            if g.bell is not None:
                return _spmd("spmd_spmm_bell", g, x)
            if g.use_halo:
                return _spmd("spmd_spmm_halo", g.src_halo, g.dst_local, g.vals, x, g.send_idx,
                             g.rows_per_shard, g.n_shards, g.halo, g.edges_local, g.group)
            return _spmd("spmd_spmm", g.src, g.dst_local, g.vals, x, g.rows_per_shard, g.group)
        if g.strategy == "dense":
            full_precision_matmuls()
            return torch.matmul(g.a_dense, x.to(g.a_dense.dtype)).to(x.dtype)
        if g.strategy == "bell":
            return library.spmm(x, g.bell, g.t_bell, g.n_pad, g.c_pad, grad_work)
        if g.strategy == "ell":
            return library.spmm(x, g.ell, g.t_ell, g.n_pad, g.c_pad, grad_work)
        return library.spmm(x, g.seg, g.t_seg, g.n_pad, g.c_pad, grad_work)


def spmm_ev(g: Graph, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Aggregate with learned per-edge values (e_pad,), forward edge order.

    The gradient flows to both `vals` (SDDMM) and `x` (transpose SpMM):
    the autograd contract of gala_tpu's spmm_ev.  On 'bell', whose binned
    layout keeps no slot -> edge permutation, it runs the segment executor
    over the edge lists, as gala_tpu falls back to its segment path.  On
    a rank's ShardGraph the sharded form: the bell layouts with their
    slot <-> edge maps, else the halo exchange, else the all_gather."""
    if g.strategy == "spmd":
        if g.ev is not None:
            return _spmd("spmd_spmm_ev_bell", g, vals, x)
        if g.use_halo:
            return _spmd("spmd_spmm_halo", g.src_halo, g.dst_local, vals, x, g.send_idx,
                         g.rows_per_shard, g.n_shards, g.halo, g.edges_local, g.group)
        return _spmd("spmd_spmm_ev", g.src, g.dst_local, vals, x, g.rows_per_shard, g.group)
    if g.src is None:
        raise ValueError(f"spmm_ev on a {g.strategy!r} graph built without edge lists; "
                         "rebuild with edge_vals=True")
    x = x.contiguous()
    if g.strategy == "dense":
        return DenseSpmmEv.apply(vals, x, g.src, g.dst, g.n_pad, g.c_pad)
    lay, t_lay = (g.ell, g.t_ell) if g.strategy == "ell" else (g.seg, g.t_seg)
    return library.spmm_ev(vals.contiguous(), x, lay, t_lay, g.src, g.dst, g.n_pad, g.c_pad)


def spmm_sampled(g: Graph, x: torch.Tensor, k: int, ra: int, rb: int) -> torch.Tensor:
    """Aggregation over k dynamically sampled neighbors per node: row r
    sums x at its in-row positions (ra*i + rb) mod deg[r], i < k, with
    repetition ((ra, rb) fresh per epoch in the dynamic mode, 5/7 where
    none is given).  On 'bell' each pick carries its edge's structural
    value; on 'dense', 'ell' and 'segment' the value 1, as gala_tpu's.
    The graph must be built with dynamic_sample=True; `x` is (c_pad, F),
    the result (n_pad, F) in x's dtype.  Single device only."""
    if g.strategy == "spmd":
        raise NotImplementedError("dynamic neighbor sampling is single-chip only; compile "
                                  "without aggrFn.sample(...).dynamic() for SPMD execution")
    if g.dyn_f is None:
        raise ValueError(f"spmm_sampled on a {g.strategy!r} graph built without its sampling "
                         "inputs; build it with Graph.from_host(dynamic_sample=True)")
    bell = g.strategy == "bell"
    lay, t_lay = (g.bell, g.t_bell) if bell else (g.seg, g.t_seg)
    return SampledSpmm.apply(x.contiguous(), lay, t_lay, g.dyn_f, g.dyn_t, bell, int(k),
                             int(ra), int(rb), g.n_pad, g.c_pad)


def spmm_direct(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Non-differentiable aggregation (AGGREGATE_MUL_SUM_DIRECT), e.g. the
    degree computation A @ ones used for normalization; always detached."""
    with torch.no_grad():
        return spmm(g, x)


def degrees(g: Graph) -> torch.Tensor:
    """In-degree column vector (n_pad, 1), precomputed at graph build,
    matching SpMM(A, ones) on the padded graph."""
    return g.deg
