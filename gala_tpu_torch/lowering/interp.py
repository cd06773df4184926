"""IR interpretation: Program -> PyTorch callables (the port of
gala_tpu.lowering.interp).

Each ComputeNode maps to a PyTorch op, run eagerly; the sparse
aggregation goes through gala_tpu_torch.ops.spmm (the SpMM kernel on the
GPU, with the SDDMM kernel for the gradient of learned edge values), the
fused attention through gala_tpu_torch.ops.attention (the attention
kernels on the GPU) and the edge ops of the unfused chain through
gala_tpu_torch.ops.edge.

Contract (shared with gala_tpu_torch.train.train):
    init_params(gen, dim_env)            -> params (nn.ModuleDict)
    invariant(graphs, x)                 -> carry (hoisted tensors)
    forward(params, graphs, carry)       -> logits (n_pad, n_classes)
    forward_rows(params, graphs, carry, rows) -> logits of `rows`

The hoisted pre-loop section (training-invariant code motion product) is
evaluated once per graph set; its outputs ride in `carry`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gala_tpu_torch.ir.compute_ir import CompOpt, ComputeNode, ComputeOp, OpType, Program
from gala_tpu_torch.ir.data_ir import DataFormat
from gala_tpu_torch.models.common import linear, linear_init
from gala_tpu_torch.ops.attention import attention_aggregate
from gala_tpu_torch.ops.edge import edge_softmax, leaky_relu, sddvv_add, sddvv_mul
from gala_tpu_torch.ops.graph import Graph, not_ported
from gala_tpu_torch.ops.spmm import spmm, spmm_direct, spmm_ev

_FFN_OPS = (ComputeOp.FFN, ComputeOp.FFN_EDGE, ComputeOp.FFN_SELF, ComputeOp.FFN_REPEAT)


def _resolve(dim: int, dim_env: dict[int, int]) -> int:
    return dim_env.get(dim, dim) if dim < 0 else dim


def param_specs(prog: Program) -> list[tuple[str, str, tuple[int, int], int]]:
    """(kind, name, (rows, cols), layer) for every learned tensor."""
    specs = []
    seen = set()
    for node in prog.all_nodes():
        if node.op in _FFN_OPS:
            w = node.inputs[1]
            if w.name not in seen:
                seen.add(w.name)
                specs.append(("linear", w.name, (w.rows, w.cols), node.layer))
        elif node.op is ComputeOp.SCALAR_ADD_EPS_MULTIPLY:
            name = f"eps{node.layer + 1}"
            if name not in seen:
                seen.add(name)
                specs.append(("eps", name, (1, 1), node.layer))
    return specs


def make_init_params(prog: Program):
    specs = param_specs(prog)

    def init_params(gen: torch.Generator, dim_env: dict[int, int]) -> nn.ModuleDict:
        params = nn.ModuleDict()
        for kind, name, (r, c), _layer in specs:
            if kind != "linear":
                raise not_ported("learned epsilon (GIN)", "ROADMAP Queue 1 item 4")
            params[name] = linear_init(gen, _resolve(r, dim_env), _resolve(c, dim_env))
        return params

    return init_params


def _graph_for(node: ComputeNode, graphs) -> Graph:
    li = node.layer
    if 0 <= li < len(graphs):
        return graphs[li]
    return graphs[0]


def _eval_node(node: ComputeNode, env, params, graphs):
    # strict input resolution: every data input must be in the env except
    # structural graph arguments (routed via _graph_for) and weight
    # placeholders (routed via params)
    ins = []
    for d in node.inputs:
        if d.uid in env:
            ins.append(env[d.uid])
        elif d.is_graph or d.fmt is DataFormat.CM:
            continue
        else:
            raise KeyError(
                f"unresolved input '{d.name}' (uid {d.uid}) of op {node.op} "
                f"— IR wiring bug (producer missing or not exported)"
            )
    op = node.op

    g0 = graphs[0]
    if op is ComputeOp.ONES:
        return torch.ones((g0.n_pad, 1), dtype=torch.float32, device=g0.device)
    if op is ComputeOp.FULL:
        return torch.full((g0.n_pad, 1), float(node.params[0]), dtype=torch.float32,
                          device=g0.device)
    if op is ComputeOp.AGGREGATE_MUL_SUM_DIRECT:
        return spmm_direct(_graph_for(node, graphs), ins[0])
    if op is ComputeOp.POWER:
        p = float(node.params[0])
        x = ins[0]
        safe = torch.where(x > 0, x, torch.ones_like(x))
        # detached, zero on padding rows (reference: pow(deg, v).detach())
        return torch.where(x > 0, safe.pow(p), torch.zeros_like(x)).detach()
    if op is ComputeOp.ROW_BROADCAST:
        return ins[0].to(ins[1].dtype) * ins[1]
    if op is ComputeOp.AGGREGATE_MUL_SUM:
        g = _graph_for(node, graphs)
        if len(node.inputs) >= 3:  # [feats, graph, edge_vals]
            return spmm_ev(g, env[node.inputs[2].uid], ins[0])
        if node.get_opt(CompOpt.SAMPLE_DYNAMIC):
            raise not_ported("dynamic sampling", "ROADMAP Queue 1 item 8")
        return spmm(g, ins[0])
    if op is ComputeOp.FUSED_ATTENTION:
        g = _graph_for(node, graphs)
        x, vl, vr = ins[0], ins[1], ins[2]
        slope = float(node.params[0]) if node.params else 0.2
        if g.attn is not None:
            return attention_aggregate(g.n_pad, g.c_pad, slope, g.attn, x, vl, vr)
        # unfused fallback (graph built without the attention layout)
        logits = leaky_relu(sddvv_add(g, vl, vr), slope)
        return spmm_ev(g, edge_softmax(g, logits), x)
    if op is ComputeOp.AGGREGATE_EDGE_SUM:
        return sddvv_add(_graph_for(node, graphs), ins[0], ins[1])
    if op is ComputeOp.AGGREGATE_EDGE_MUL:
        g = _graph_for(node, graphs)
        # structural vals mask padding (and carry weights when weighted)
        return sddvv_mul(g, ins[0], ins[1]) * g.vals
    if op is ComputeOp.SOFTMAX and node.op_type is OpType.UPDATE_EDGE:
        return edge_softmax(_graph_for(node, graphs), ins[0])
    if op is ComputeOp.LEAKY_RELU:
        slope = float(node.params[0]) if node.params else 0.2
        return F.leaky_relu(ins[0], slope)
    if op is ComputeOp.RELU:
        return torch.relu(ins[0])
    if op in _FFN_OPS:
        return linear(params[node.inputs[1].name], ins[0])
    if op is ComputeOp.ADD:
        return ins[0] + ins[1]
    if op is ComputeOp.MUL:
        return ins[0] * ins[1]
    raise NotImplementedError(f"lowering for op {op} is not ported to gala_tpu_torch")


# ops whose outputs depend only on their own row — a row subset can be
# selected before them without changing those rows' values
_ROW_LOCAL_OPS = frozenset({
    ComputeOp.FFN, ComputeOp.FFN_EDGE, ComputeOp.FFN_SELF,
    ComputeOp.FFN_REPEAT, ComputeOp.RELU, ComputeOp.LEAKY_RELU, ComputeOp.ROW_BROADCAST,
    ComputeOp.ADD, ComputeOp.MUL, ComputeOp.SCALAR_ADD_EPS_MULTIPLY,
})


def make_forward(prog: Program):
    """Build (invariant, forward, forward_rows) interpreters over the
    optimized IR.

    forward_rows(params, graphs, carry, rows) evaluates the loop but
    switches to the `rows` node subset at the last point where every
    remaining op is row-local — the training loss then pays for the
    classifier FFN and logits only on train-mask rows."""
    pre_nodes = [n for n in prog.pre if n.op is not ComputeOp.LOAD]
    loop_nodes = prog.loop.nodes if prog.loop else []
    feats_uid = None
    for n in prog.pre:
        if n.op is ComputeOp.LOAD:
            feats_uid = n.outputs[0].uid

    # the carry exports every pre-node output the loop actually reads
    loop_reads = {d.uid for n in loop_nodes for d in n.inputs}

    # cut = first index from which every node is row-local
    cut = len(loop_nodes)
    while cut > 0 and loop_nodes[cut - 1].op in _ROW_LOCAL_OPS:
        cut -= 1

    def invariant(graphs, x):
        env = {feats_uid: x}
        for node in pre_nodes:
            env[node.outputs[0].uid] = _eval_node(node, env, {}, graphs)
        return {u: v for u, v in env.items() if u in loop_reads or u == feats_uid}

    def forward(params, graphs, carry):
        env = dict(carry) if isinstance(carry, dict) else {feats_uid: carry}
        out = None
        for node in loop_nodes:
            out = _eval_node(node, env, params, graphs)
            env[node.outputs[0].uid] = out
        return out

    def forward_rows(params, graphs, carry, rows):
        env = dict(carry) if isinstance(carry, dict) else {feats_uid: carry}
        n_full = graphs[0].n_pad
        out = None
        for i, node in enumerate(loop_nodes):
            if i == cut:
                env = {
                    u: v[rows]
                    if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == n_full
                    else v
                    for u, v in env.items()
                }
            out = _eval_node(node, env, params, graphs)
            env[node.outputs[0].uid] = out
        if cut == len(loop_nodes):
            out = out[rows]
        return out

    return invariant, forward, forward_rows
