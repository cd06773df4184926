"""Pass 2: sparsity-aware rewrites.

Clean-room equivalent of `GALATransformations::sparsityAwareRewrites`
(reference: src/middle-end/middle-end.h:213-406).  When the schedule marks
the graph `is_sparser`, the symmetric-normalization sandwich

    res = norm * (A @ (norm * X))

is rewritten so the two row-broadcasts fold into precomputed edge values:

    ev  = norm[src] * norm[dst] * A.vals      (SDDVV-mul, loop-invariant)
    res = A_ev @ X                            (SpMM with edge values)

An FFN may sit between the aggregation and the trailing broadcast
(norm * ((A @ X') W) == (norm * (A @ X')) W), which the pattern matcher
tolerates.  The edge-value computation is emitted at the pattern site and
is later hoisted out of the loop by training-invariant code motion.
"""
from __future__ import annotations

from gala_tpu_torch.ir.compute_ir import ComputeNode, ComputeOp, OpType, Program
from gala_tpu_torch.ir.data_ir import DataFormat, DataNode, SYM_CLASSES, SYM_FEATS


def _producer_of(loop_nodes, data):
    for n in loop_nodes:
        if data in n.outputs:
            return n
    return None


def sparsity_aware_rewrites(prog: Program) -> Program:
    loop = prog.loop
    if loop is None:
        return prog

    changed = True
    while changed:
        changed = False
        for agg in list(loop.nodes):
            if agg.op is not ComputeOp.AGGREGATE_MUL_SUM or len(agg.inputs) > 2:
                continue
            graph = agg.inputs[1]
            if not graph.sparser:
                continue
            rb1 = _producer_of(loop.nodes, agg.inputs[0])
            if rb1 is None or rb1.op is not ComputeOp.ROW_BROADCAST:
                continue
            # trailing broadcast: directly on the aggregate output, or on
            # an FFN applied to it
            mid = None
            rb2 = None
            for n in loop.nodes:
                if n.op is ComputeOp.ROW_BROADCAST and n.inputs[1] is agg.outputs[0]:
                    rb2 = n
                    break
                if n.op is ComputeOp.FFN and n.inputs[0] is agg.outputs[0]:
                    mid = n
            if rb2 is None and mid is not None:
                for n in loop.nodes:
                    if n.op is ComputeOp.ROW_BROADCAST and n.inputs[1] is mid.outputs[0]:
                        rb2 = n
                        break
            if rb2 is None:
                continue
            norm = rb1.inputs[0]
            if rb2.inputs[0] is not norm:
                continue

            # --- rewrite ------------------------------------------------- #
            ev = DataNode(
                name=f"edge_norm_vals{agg.layer + 1}",
                fmt=DataFormat.CSR,
                directed=graph.directed,
                weighted=True,
                derived=True,
                index=graph.index,
            )
            ev_node = ComputeNode(
                op_type=OpType.AGGREGATE_EDGE,
                op=ComputeOp.AGGREGATE_EDGE_MUL,
                inputs=[norm, norm, graph],
                outputs=[ev],
                layer=agg.layer,
            )
            loop.insert(loop.nodes.index(rb1), ev_node)

            # aggregation consumes rb1's feature input + the edge values
            agg.inputs[0] = rb1.inputs[1]
            agg.inputs.append(ev)
            # remove rb1; splice rb2 out by moving its output onto its
            # producer (FFN or the aggregate), keeping downstream wiring
            tail = mid if (mid is not None and rb2.inputs[1] is mid.outputs[0]) else agg
            tail.outputs[0] = rb2.outputs[0]
            loop.nodes.remove(rb1)
            loop.nodes.remove(rb2)
            changed = True
            break
    return prog


def ffn_recompute_rewrites(prog: Program, dim_env: dict | None = None) -> Program:
    """FFN-recompute rewrite (reference: src/middle-end/middle-end.h:325-380,
    the FFN_OP_REPEAT half of sparsityAwareRewrites).

    When an EXPANDING FFN (in_cols < out_cols) feeds both an earlier
    consumer and a dense-graph aggregation, the aggregation is rewritten
    to consume the FFN's (narrower) input — the SpMM streams fewer
    feature columns — and the same weight is re-applied AFTER the
    aggregation via an FFN_REPEAT node (A @ (X W) == (A @ X) W).  The
    original FFN stays for its other consumer; only the aggregation's
    operand narrows.  Mirrors the reference's guards: the aggregation
    must be a 2nd-or-later use of the FFN output (a sole use is handled
    by operator reordering instead) and the graph must NOT be marked
    sparser (there the SDDVV rewrite above applies)."""
    loop = prog.loop
    if loop is None:
        return prog
    env = dim_env or {}

    def cols_of(d: DataNode) -> int:
        c = d.cols
        return env.get(c, c) if c < 0 else c

    changed = True
    while changed:
        changed = False
        for i, ffn in enumerate(loop.nodes):
            if ffn.op is not ComputeOp.FFN:
                continue
            out = ffn.outputs[0]
            in_cols = cols_of(ffn.inputs[0])
            out_cols = cols_of(out)
            if in_cols < 0 or out_cols < 0 or in_cols >= out_cols:
                continue
            uses = 0
            for j in range(i + 1, len(loop.nodes)):
                n = loop.nodes[j]
                if (uses > 0 and n.op is ComputeOp.AGGREGATE_MUL_SUM
                        and n.inputs and n.inputs[0] is out
                        and len(n.inputs) == 2
                        and not n.inputs[1].sparser):
                    orig = n.outputs[0]
                    small = orig.clone(
                        name=orig.name + "_pre",
                        cols=ffn.inputs[0].cols,
                        derived=True,
                    )
                    n.inputs[0] = ffn.inputs[0]
                    n.outputs[0] = small
                    rep = ComputeNode(
                        op_type=OpType.UPDATE_NODE,
                        op=ComputeOp.FFN_REPEAT,
                        inputs=[small, ffn.inputs[1]],
                        outputs=[orig],
                        layer=n.layer,
                    )
                    loop.insert(j + 1, rep)
                    changed = True
                    break
                if n.inputs and n.inputs[0] is out:
                    uses += 1
            if changed:
                break
    return prog
