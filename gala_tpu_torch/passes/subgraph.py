"""Pass 4: training-invariant subgraph extraction.

Clean-room equivalent of `GALATransformations::trainingSubGraph`
(reference: src/middle-end/middle-end.h:39-210): training-epoch gradients
only need the L-hop in-neighborhood of the train mask, so each in-loop
aggregation is re-pointed at a per-layer mask-derived subgraph adj1..adjL
(validation epochs keep the full graph).  The host-side subgraph builder
is gala_tpu_torch.data.subgraph.mask_subgraphs (the reference's
`getMaskSubgraphs`, tests/common.h:20-123).

IR effect: per-layer subgraph DataNodes + SUBGRAPH TransformEdges, and
each trainable aggregation/edge op records the subgraph slot (its `layer`
field already indexes into the per-layer graph list the lowering passes
at execution time).
"""
from __future__ import annotations

from gala_tpu_torch.ir.compute_ir import ComputeOp, Program
from gala_tpu_torch.ir.data_ir import DataOpt, TransformData, TransformEdge

SUBGRAPH_OPS = frozenset(
    {
        ComputeOp.AGGREGATE_MUL_SUM,
        ComputeOp.AGGREGATE_EDGE_SUM,
        ComputeOp.AGGREGATE_EDGE_MUL,
        ComputeOp.SOFTMAX,
    }
)


def training_subgraph(prog: Program) -> Program:
    loop = prog.loop
    if loop is None:
        return prog

    # layers that still aggregate inside the loop (post code motion the
    # hoisted first layer no longer needs a subgraph slot)
    layers = sorted(
        {n.layer for n in loop.nodes if n.op in SUBGRAPH_OPS and n.layer >= 0}
    )
    if not layers:
        return prog

    base_graph = None
    for n in prog.all_nodes():
        for d in [*n.inputs, *n.outputs]:
            if d.is_graph and not d.derived:
                base_graph = d
                break
        if base_graph is not None:
            break
    if base_graph is None:
        return prog

    n_layers = prog.n_layers
    for li in layers:
        sub = base_graph.clone(name=f"adj{li + 1}", derived=True)
        # layer li (0-based) influences the loss through n_layers-li hops
        hops = n_layers - li
        sub.add_opt(DataOpt.SUBGRAPH, float(hops))
        te = TransformEdge(base_graph, sub)
        te.transforms.append(TransformData(DataOpt.SUBGRAPH, [float(hops), float(li)]))
        prog.transforms.append(te)

    prog.uses_training_subgraphs = True
    return prog
