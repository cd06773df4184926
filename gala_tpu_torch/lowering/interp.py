"""IR interpretation: Program -> PyTorch callables (the port of
gala_tpu.lowering.interp).

Each ComputeNode maps to a PyTorch op, run eagerly; the sparse
aggregation goes through gala_tpu_torch.ops.spmm (the SpMM kernel on the
GPU, with the SDDMM kernel for the gradient of learned edge values), the
fused attention through gala_tpu_torch.ops.attention (the attention
kernels on the GPU) and the edge ops of the unfused chain through
gala_tpu_torch.ops.edge.  On a rank's ShardGraph (parallel.compiled) the
same program runs sharded: node-sized constants take the rank's rows,
the ops dispatch to parallel.ops, and a TP plan on the graph splits the
FFNs (parallel.tp).

Contract (shared with gala_tpu_torch.train.train):
    init_params(gen, dim_env)            -> params (models.common.ParamDict)
    invariant(graphs, x)                 -> carry (hoisted tensors)
    forward(params, graphs, carry)       -> logits (n_pad, n_classes)
    forward_rows(params, graphs, carry, rows) -> logits of `rows`

A FUSED_ATTENTION node whose one reader is lowering.heads' head_mean
node (`mean_folds`) runs, where the attention kernels run, as one
attention op that returns the mean over its heads (its gradient then
holds the mean's dout once for all heads, ops.attention); the spmd branch
and the unfused fallback take the mean after the attention, as before.

The hoisted pre-loop section (training-invariant code motion product) is
evaluated once per graph set; its outputs ride in `carry`.  The carry
also brings the epoch's dynamic-sampling pair as "_ra"/"_rb" (Python
ints); an aggregation with no pair in its env (the hoisted prefix)
samples with gala_tpu's fixed (5, 7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from gala_tpu_torch.ir.compute_ir import CompOpt, ComputeNode, ComputeOp, OpType, Program
from gala_tpu_torch.ir.data_ir import DataFormat
from gala_tpu_torch.models.common import (
    ParamDict, epsilon_param, linear, linear_init, scale_by_eps,
)
from gala_tpu_torch.ops.attention import attention_aggregate, elu, head_mean, head_scores
from gala_tpu_torch.ops.edge import edge_softmax, leaky_relu, sddvv_add, sddvv_mul
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.spmm import spmm, spmm_direct, spmm_ev, spmm_sampled

_FFN_OPS = (ComputeOp.FFN, ComputeOp.FFN_EDGE, ComputeOp.FFN_SELF, ComputeOp.FFN_REPEAT)
_TRANSFORMS = {"head_mean": head_mean, "elu": elu}


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

    def init_params(gen: torch.Generator, dim_env: dict[int, int]) -> ParamDict:
        params = ParamDict()
        for kind, name, (r, c), _layer in specs:
            if kind == "linear":
                params[name] = linear_init(gen, _resolve(r, dim_env), _resolve(c, dim_env))
            else:
                params[name] = epsilon_param()  # GIN
        return params

    return init_params


def _graph_for(node: ComputeNode, graphs) -> Graph:
    li = node.layer
    if 0 <= li < len(graphs):
        return graphs[li]
    return graphs[0]


def mean_folds(nodes) -> dict[int, ComputeNode]:
    """{id of a FUSED_ATTENTION node: the head_mean TRANSFORM node that is
    the one reader of its output, over as many heads as its scores have}
    among `nodes` (lowering.heads inserts the mean after the output
    layer's attention): the pairs evaluated as one attention op that
    returns the mean over its heads."""
    readers: dict[int, list[ComputeNode]] = {}
    for n in nodes:
        for d in n.inputs:
            readers.setdefault(d.uid, []).append(n)
    folds = {}
    for n in nodes:
        if n.op is ComputeOp.FUSED_ATTENTION:
            rs = readers.get(n.outputs[0].uid, [])
            if (len(rs) == 1 and rs[0].op is ComputeOp.TRANSFORM
                    and rs[0].params[0] == "head_mean"
                    and int(rs[0].params[1]) == n.inputs[1].cols):
                folds[id(n)] = rs[0]
    return folds


def _eval_node(node: ComputeNode, env, params, graphs, mean: ComputeNode | None = None):
    # mean: the head_mean node that mean_folds pairs with a FUSED_ATTENTION
    # node, whose output this evaluation then returns
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

    # node-sized constants: a rank's own rows on a ShardGraph (local_rows),
    # the padded node count otherwise
    g0 = graphs[0]
    n_rows = getattr(g0, "local_rows", None) or g0.n_pad
    if op is ComputeOp.ONES:
        return torch.ones((n_rows, 1), dtype=torch.float32, device=g0.device)
    if op is ComputeOp.FULL:
        return torch.full((n_rows, 1), float(node.params[0]), dtype=torch.float32,
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
        k_dyn = node.get_opt(CompOpt.SAMPLE_DYNAMIC)
        if k_dyn:
            # per-epoch (ra, rb) arrive through the carry (train's
            # epoch_inputs); static kernel sampling was lowered to a
            # data-level resample in lower()
            return spmm_sampled(g, ins[0], int(k_dyn), env.get("_ra", 5), env.get("_rb", 7))
        return spmm(g, ins[0])
    if op is ComputeOp.FUSED_ATTENTION:
        g = _graph_for(node, graphs)
        x, vl, vr = ins[0], ins[1], ins[2]
        slope = float(node.params[0]) if node.params else 0.2
        if g.strategy != "spmd" and g.attn is not None:
            # the attention kernels; with a mean over the heads after it,
            # one op that returns the mean
            return attention_aggregate(g.n_pad, g.c_pad, slope, g.attn, x, vl, vr,
                                       mean=mean is not None)
        if g.strategy == "spmd":
            # sharded: one [x | vl] exchange serves scores and aggregation
            from gala_tpu_torch.parallel.ops import spmd_attention

            out = spmd_attention(g, x, vl, vr, slope)
        else:
            # unfused fallback (graph built without the attention layout),
            # head by head as models/gat.py: head h's scores weight its
            # own fh-wide slice of x
            n_heads = vl.shape[1]
            fh = x.shape[1] // n_heads
            outs = []
            for h in range(n_heads):
                logits = leaky_relu(sddvv_add(g, vl[:, h : h + 1], vr[:, h : h + 1]), slope)
                outs.append(spmm_ev(g, edge_softmax(g, logits), x[:, h * fh : (h + 1) * fh]))
            out = torch.cat(outs, dim=1) if n_heads > 1 else outs[0]
        return out if mean is None else head_mean(out, int(mean.params[1]))
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
    if op is ComputeOp.TRANSFORM:
        # lowering.heads: "head_mean" over the output heads, "elu"
        name, heads = node.params
        return _TRANSFORMS[name](ins[0], int(heads))
    if op is ComputeOp.FFN_EDGE and node.params:
        # lowering.heads: each head's score from its own columns
        return head_scores(params[node.inputs[1].name], ins[0], int(node.params[0]))
    if op in _FFN_OPS:
        w = node.inputs[1]
        split = (getattr(g0, "tp_plan", None) or {}).get(w.name)
        if split:
            # tensor parallelism: this rank's weight slice, with the
            # model-axis collectives of parallel.tp
            from gala_tpu_torch.parallel.tp import tp_linear

            return tp_linear(params[w.name], ins[0], split, g0.model_group)
        return linear(params[w.name], ins[0])
    if op is ComputeOp.SCALAR_ADD_EPS_MULTIPLY:
        return scale_by_eps(params[f"eps{node.layer + 1}"], ins[0])
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
    ComputeOp.TRANSFORM,
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

    # an attention with a mean over its heads after it writes the mean's
    # output, and the mean node is passed over
    folds = mean_folds(loop_nodes)
    folded = {id(m) for m in folds.values()}

    def step(node, env, params, graphs):
        if id(node) in folded:
            return env[node.outputs[0].uid]
        mean = folds.get(id(node))
        out = _eval_node(node, env, params, graphs, mean)
        env[(node if mean is None else mean).outputs[0].uid] = out
        return out

    def invariant(graphs, x):
        env = {feats_uid: x}
        for node in pre_nodes:
            env[node.outputs[0].uid] = _eval_node(node, env, {}, graphs)
        return {u: v for u, v in env.items() if u in loop_reads or u == feats_uid}

    def forward(params, graphs, carry):
        env = dict(carry) if isinstance(carry, dict) else {feats_uid: carry}
        out = None
        for node in loop_nodes:
            out = step(node, env, params, graphs)
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
            out = step(node, env, params, graphs)
        if cut == len(loop_nodes):
            out = out[rows]
        return out

    return invariant, forward, forward_rows
