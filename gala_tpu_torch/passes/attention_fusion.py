"""Attention-fusion pass (TPU-specific, pass #5).

Recognizes the edge-centric attention chain the frontend builds for GAT
layers (reference: src/frontend/frontend.y addAttentionWeight_L/R,
addAttn, addSoftmax_CIR emit exactly this sequence):

    attn = AGGREGATE_EDGE_SUM(el, er, G)     # vl[src] + vr[dst]
    attn = LEAKY_RELU(attn)
    attn = SOFTMAX(attn)                     # per-destination edge softmax
    out  = AGGREGATE_MUL_SUM(x, G, attn)     # SpMM with softmax values

and rewrites it into a single FUSED_ATTENTION node lowered to the
slot-space op (gala_tpu_torch.ops.attention.attention_aggregate): one row
gather per layer instead of four edge-sized gather/scatter chains.

The rewrite fires only when the intermediate edge tensors have no other
consumers, so any nonstandard DSL program falls back to the edge-centric
lowering unchanged.
"""
from __future__ import annotations

from gala_tpu_torch.ir.compute_ir import ComputeNode, ComputeOp, OpType, Program


def _consumers(nodes, data_uid, exclude):
    return [
        n for n in nodes
        if n not in exclude and any(d.uid == data_uid for d in n.inputs)
    ]


def attention_fusion(prog: Program) -> Program:
    if prog.loop is None:
        return prog
    for nodes in ([prog.pre, prog.loop.nodes] if prog.loop else [prog.pre]):
        i = 0
        while i + 3 < len(nodes):
            n1, n2, n3, n4 = nodes[i : i + 4]
            ok = (
                n1.op is ComputeOp.AGGREGATE_EDGE_SUM
                and n2.op is ComputeOp.LEAKY_RELU
                and n3.op is ComputeOp.SOFTMAX
                and n3.op_type is OpType.UPDATE_EDGE
                and n4.op is ComputeOp.AGGREGATE_MUL_SUM
                and len(n4.inputs) >= 3
                and n2.inputs[0].uid == n1.outputs[0].uid
                and n3.inputs[0].uid == n2.outputs[0].uid
                and n4.inputs[2].uid == n3.outputs[0].uid
            )
            if ok:
                chain = {n1, n2, n3, n4}
                all_nodes = prog.pre + (prog.loop.nodes if prog.loop else [])
                for mid in (n1.outputs[0], n2.outputs[0], n3.outputs[0]):
                    if _consumers(all_nodes, mid.uid, chain):
                        ok = False
                        break
            if ok:
                slope = float(n2.params[0]) if n2.params else 0.2
                fused = ComputeNode(
                    op_type=OpType.AGGREGATE_NODE,
                    op=ComputeOp.FUSED_ATTENTION,
                    inputs=[n4.inputs[0], n1.inputs[0], n1.inputs[1]],
                    outputs=[n4.outputs[0]],
                    params=[str(slope)],
                    layer=n4.layer,
                )
                nodes[i : i + 4] = [fused]
            i += 1
    return prog


def has_fused_attention(prog: Program) -> bool:
    return any(n.op is ComputeOp.FUSED_ATTENTION for n in prog.all_nodes())