"""Pass 1: complexity-aware operator reordering.

Clean-room equivalent of `GALATransformations::complexityOperatorReordering`
(reference: src/middle-end/middle-end.h:494-876).  FFN nodes bubble past
aggregation and row-broadcast nodes so the O(E * F) SpMM runs in the
smaller feature dimension:

    A @ (X W) == (A @ X) W          (matmul associativity)
    (norm * X) W == norm * (X W)    (row scaling commutes with right-mul)

- Default mode: if the FFN shrinks the width (w_out < w_in), move it
  *before* the preceding AGGREGATE/ROW_BROADCAST chain; if it grows the
  width, move it *after* a following chain.
- enable_tim mode (training driver): never move an FFN earlier — a longer
  learned-op-free prefix maximizes what training-invariant code motion
  can hoist (reference: gala_train.cpp enables TIM-aware reordering).
- TPU cost model (r5): even in default mode, an FFN never moves ahead
  of a PARAMETER-FREE chain.  A param-free prefix is hoistable — by the
  TIM pass in train mode, and by XLA's loop-invariant code motion
  inside the fused epoch scan at run time — so it costs ~0 per epoch;
  bubbling the FFN past it makes the chain param-dependent and turns a
  free sweep into a per-epoch one (measured: table5 Reddit-0.25 `all`
  ran two in-loop 32-wide sweeps at 0.41s forward while `cir` kept the
  param-free 256-wide L1 sweep hoisted and ran one, 0.24s).  Moving
  early is still the win when the chain already depends on parameters
  (every layer past the first).

The rewiring swaps the two nodes' output DataNodes and re-threads inputs,
exactly preserving dataflow for downstream consumers.
"""
from __future__ import annotations

from gala_tpu_torch.ir.compute_ir import ComputeNode, ComputeOp, Program

_MOVABLE_PAST = (ComputeOp.AGGREGATE_MUL_SUM, ComputeOp.ROW_BROADCAST)


def _ffn_width(ffn: ComputeNode) -> tuple[int, int]:
    w = ffn.inputs[1]
    return w.rows, w.cols


def _feature_input_index(node: ComputeNode) -> int:
    """Index of the flowing feature operand: ROW_BROADCAST is (norm, x),
    AGGREGATE is (x, graph[, evals])."""
    return 1 if node.op is ComputeOp.ROW_BROADCAST else 0


def _swap_adjacent(loop, i: int, j: int) -> None:
    """nodes[i] (AGG/RB) feeds nodes[j] (FFN), j == i+1; after the swap the
    FFN runs first."""
    first, ffn = loop.nodes[i], loop.nodes[j]
    fi = _feature_input_index(first)
    d_mid = first.outputs[0]   # becomes the FFN's output
    d_tail = ffn.outputs[0]    # stays the chain tail for downstream readers
    ffn.inputs[0] = first.inputs[fi]
    ffn.outputs[0] = d_mid
    first.inputs[fi] = d_mid
    first.outputs[0] = d_tail
    # widths: every tensor after the FFN has w_out columns
    w_cols = ffn.inputs[1].cols
    d_mid.cols = w_cols
    d_tail.cols = w_cols
    loop.swap(i, j)


def _param_dependent(loop, d) -> bool:
    """True when the DataNode `d` transitively consumes any learned op
    (FFN) within the loop — i.e. the chain producing it is NOT
    hoistable by TIM / XLA loop-invariant code motion."""
    producers = {}
    for n in loop.nodes:
        for out in n.outputs:
            producers[id(out)] = n
    seen = set()
    stack = [d]
    while stack:
        cur = stack.pop()
        if id(cur) in seen:
            continue
        seen.add(id(cur))
        n = producers.get(id(cur))
        if n is None:
            continue  # loop input (feats/graph/pre-computed): param-free
        if n.op is ComputeOp.FFN:
            return True
        stack.extend(n.inputs)
    return False


def operator_reordering(prog: Program, enable_tim: bool = False) -> Program:
    loop = prog.loop
    if loop is None:
        return prog
    changed = True
    while changed:
        changed = False
        for j, node in enumerate(loop.nodes):
            if node.op is not ComputeOp.FFN:
                continue
            w_in, w_out = _ffn_width(node)
            if w_out < w_in and not enable_tim:
                # move earlier while the producer directly feeding us is a
                # movable op — but never onto a param-free (hoistable)
                # chain (TPU cost model, see module docstring)
                i = j - 1
                if i >= 0:
                    prev = loop.nodes[i]
                    if (
                        prev.op in _MOVABLE_PAST
                        and prev.outputs[0] is node.inputs[0]
                        and prev.layer in (node.layer, -1)
                        and _param_dependent(
                            loop, prev.inputs[_feature_input_index(prev)]
                        )
                    ):
                        _swap_adjacent(loop, i, j)
                        changed = True
                        break
            elif w_out > w_in or enable_tim:
                # move later past a movable consumer (helps TIM and keeps
                # wide SpMMs on the narrow side)
                k = j + 1
                if k < len(loop.nodes):
                    nxt = loop.nodes[k]
                    if (
                        nxt.op in _MOVABLE_PAST
                        and node.outputs[0] is nxt.inputs[_feature_input_index(nxt)]
                        and nxt.layer in (node.layer, -1)
                    ):
                        # symmetric swap: nxt runs first, FFN after
                        fi = _feature_input_index(nxt)
                        d_mid = node.outputs[0]   # becomes nxt's output
                        d_tail = nxt.outputs[0]   # stays the chain tail
                        nxt.inputs[fi] = node.inputs[0]
                        nxt.outputs[0] = d_mid
                        node.inputs[0] = d_mid
                        node.outputs[0] = d_tail
                        d_mid.cols = node.inputs[1].rows   # pre-FFN width
                        d_tail.cols = node.inputs[1].cols  # post-FFN width
                        loop.swap(j, k)
                        changed = True
                        break
    return prog
