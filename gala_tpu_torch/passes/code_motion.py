"""Pass 3: training-invariant code motion.

Clean-room equivalent of `GALATransformations::trainingInvariantCodeMotion`
(reference: src/middle-end/middle-end.h:409-489): the maximal loop prefix
containing no learned operators (FFN family, learned epsilon) moves out of
the training loop into the program's pre-loop section, so degree/
normalization computation and — crucially — the first-layer aggregation
over the full-width input features run exactly once.

Unlike the reference (which pattern-matches node positions and renames a
handoff tensor), invariance is decided by dataflow: a node is hoistable if
it is not a learned op and every input is either loop-external or produced
by an already-hoisted node.
"""
from __future__ import annotations

from gala_tpu_torch.ir.compute_ir import ComputeOp, Program

LEARNED_OPS = frozenset(
    {
        ComputeOp.FFN,
        ComputeOp.FFN_EDGE,
        ComputeOp.FFN_SELF,
        ComputeOp.FFN_REPEAT,
        ComputeOp.SCALAR_ADD_EPS_MULTIPLY,
    }
)


def training_invariant_code_motion(prog: Program) -> Program:
    loop = prog.loop
    if loop is None:
        return prog

    hoisted_outputs = set()
    loop_outputs = {d.uid for n in loop.nodes for d in n.outputs}

    # Hoist *every* invariant node, not only the leading prefix — an
    # improvement over the reference's prefix-only motion: e.g. the
    # per-layer edge-value precomputes emitted by the sparsity rewrite are
    # invariant even though they sit mid-loop.  Relative order among
    # hoisted nodes (and among remaining nodes) is preserved, so dataflow
    # is unchanged.
    hoisted, remaining = [], []
    for node in loop.nodes:
        invariant = node.op not in LEARNED_OPS and all(
            inp.uid not in loop_outputs or inp.uid in hoisted_outputs
            for inp in node.inputs
        )
        if invariant:
            hoisted_outputs.update(d.uid for d in node.outputs)
            hoisted.append(node)
        else:
            remaining.append(node)

    if hoisted:
        prog.pre.extend(hoisted)
        loop.nodes[:] = remaining
    return prog
