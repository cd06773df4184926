"""Tensor parallelism for DSL-compiled programs (the port of
gala_tpu.parallel.tp).

Megatron-style feature-dimension sharding of the FFN weights over the
mesh's 'model' axis, planned from the compute IR (`plan_tp`, gala_tpu's
planner, copied): walking the loop in order, an FFN whose input is
replicated gets COLUMN-split weights (its output is feature-sharded, no
collective); an FFN whose input is feature-sharded gets ROW-split
weights (each model rank computes a partial product, one all_reduce
restores replication).  The ops between a col-split and its closing
row-split are column-independent (elementwise, row broadcasts, graph
aggregations), so the aggregations' cost divides by the model-axis size
too.

The plan is a {weight_name: 'col' | 'row'} dict.  A rank holds the slice
of each weight that `rank_slice` gives (col: its share of the output
columns and of the bias; row: its share of the input rows, the whole
bias, added once after the sum).  shard_map's check_vma inserts the
model-axis collectives of the gradient in gala_tpu; here they are
Megatron's two conjugate operators, autograd Functions over the model
group that the interpreter's FFN lowering places (`tp_linear`):

    copy_to     before a col-split FFN: identity forward, all_reduce
                backward (each rank's input gradient is a partial sum);
    reduce_from after a row-split FFN: all_reduce forward, identity
                backward (the output is replicated).

A misplaced one gives gradients off by a factor of the model-axis size.
`reduce_from` also sums the training loss over the data group
(gala_tpu.parallel.train's psum of the loss numerator).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from gala_tpu_torch.ir.compute_ir import ComputeOp, Program
from gala_tpu_torch.models.common import full_precision_matmuls, linear


_FFN_OPS = (ComputeOp.FFN, ComputeOp.FFN_SELF, ComputeOp.FFN_EDGE,
            ComputeOp.FFN_REPEAT)
# ops that propagate feature-sharding from input to output unchanged
# (column-independent in the feature dimension)
_COLWISE = {
    ComputeOp.RELU, ComputeOp.LEAKY_RELU, ComputeOp.SCALAR_ADD_EPS_MULTIPLY,
}
# (n,1)/edge-sized ops whose operands must be replicated
_NEEDS_REPL = {
    ComputeOp.DEGREES, ComputeOp.POWER, ComputeOp.ONES, ComputeOp.FULL,
    ComputeOp.AGGREGATE_EDGE_SUM, ComputeOp.AGGREGATE_EDGE_MUL,
    ComputeOp.SOFTMAX, ComputeOp.APPLY_EDGES,
    ComputeOp.AGGREGATE_MUL_SUM_DIRECT, ComputeOp.LOG_SOFTMAX,
}


def plan_tp(prog: Program, dim_env: dict[int, int], n_model: int
            ) -> dict[str, str] | None:
    """Assign col/row splits to the program's FFN weights, or None when
    the program cannot be TP-sharded safely (indivisible dims, an op
    that would see mixed shardings, a shared weight with conflicting
    assignments, or a feature-sharded final output)."""
    if n_model <= 1 or prog.loop is None:
        return None

    def rdim(d: int) -> int:
        return dim_env.get(d, d) if d < 0 else d

    splits: dict[str, str] = {}
    sharded: set[int] = set()      # data uids whose feature dim is split

    def assign(name: str, split: str) -> bool:
        if splits.get(name, split) != split:
            return False           # shared weight, conflicting roles
        splits[name] = split
        return True

    for node in prog.loop.nodes:
        op = node.op
        ins_sh = [d.uid in sharded for d in node.inputs]
        if op in _FFN_OPS:
            w = node.inputs[1]
            if ins_sh[0]:
                # close the pair: row-split, psum'd -> replicated out
                if rdim(w.rows) % n_model or not assign(w.name, "row"):
                    return None
            else:
                prev = splits.get(w.name)
                if prev == "row":
                    return None    # shared weight, conflicting roles
                if prev == "col" or (
                    prev is None and rdim(w.cols) % n_model == 0
                ):
                    splits[w.name] = "col"
                    sharded.add(node.outputs[0].uid)
                # else: indivisible output dim (e.g. a 1-wide attention
                # vector) — leave this weight replicated, output stays
                # replicated; the rest of the program can still split
        elif op in _COLWISE:
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op is ComputeOp.ROW_BROADCAST:
            # inputs [norm(n,1), X]: the broadcast vector must be replicated
            if ins_sh[0]:
                return None
            if ins_sh[1]:
                sharded.add(node.outputs[0].uid)
        elif op in (ComputeOp.ADD, ComputeOp.MUL):
            if ins_sh[0] != ins_sh[1]:
                return None        # sharded + replicated: ill-typed
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op is ComputeOp.AGGREGATE_MUL_SUM:
            # SpMM is row-mixing, column-independent; edge values (input
            # 3) and the graph are replicated over 'model'
            if any(ins_sh[1:]):
                return None
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op is ComputeOp.FUSED_ATTENTION:
            # inputs [x, vl, vr]: scores read vl/vr only -> they must be
            # replicated; the aggregation is column-independent in x
            if ins_sh[1] or ins_sh[2]:
                return None
            if ins_sh[0]:
                sharded.add(node.outputs[0].uid)
        elif op in _NEEDS_REPL:
            if any(ins_sh):
                return None
        else:
            if any(ins_sh):
                return None        # unknown op: stay conservative
    if not splits:
        return None
    last = prog.loop.nodes[-1]
    if last.outputs and last.outputs[0].uid in sharded:
        return None                # logits must come out replicated
    return splits


def rank_slice(split: str | None, key: str, a: np.ndarray, m: int, n_model: int) -> np.ndarray:
    """The part of a linear layer's array `key` ("w" (d_in, d_out) or "b"
    (d_out,)) that model rank m of n_model holds under `split` (gala_tpu's
    param_pspecs): col, its 1/n_model of the output columns of w and b;
    row, its 1/n_model of the input rows of w and the whole b; None, all."""
    if split is None or (split == "row" and key == "b"):
        return a
    axis = 1 if (split == "col" and key == "w") else 0
    k = a.shape[axis] // n_model
    return np.take(a, np.arange(m * k, (m + 1) * k), axis=axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all_reduce (sum) of the gradient over `group`."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce (sum) over `group` forward, identity gradient."""
    return _ReduceFrom.apply(x, group)


def tp_linear(p, x: torch.Tensor, split: str, group) -> torch.Tensor:
    """An FFN on this rank's weight slice: col-split behind copy_to;
    row-split summed over the model group, then the bias once."""
    if split == "col":
        return linear(p, copy_to(x, group))
    full_precision_matmuls()
    return reduce_from(torch.matmul(x, p["w"].to(x.dtype)), group) + p["b"].to(x.dtype)
