"""IR generation: ModelSpec -> Program.

Clean-room equivalent of the reference's `generate_ir` + `addLayer` +
`add*_CIR` helpers (reference: src/frontend/frontend.y:464-1108).  The
reference threads a single `prevData` pointer through position-dependent
special cases; here the same semantics are expressed with explicit
dataflow state per layer (layer_input / prev / aggr_out / res / norm),
which produces the same op sequences for the GCN/GAT/GIN/SAGE families.
"""
from __future__ import annotations

from gala_tpu_torch.dsl.spec import LayerOp, ModelSpec
from gala_tpu_torch.ir.compute_ir import (
    CompOpt,
    ComputeNode,
    ComputeOp,
    OpType,
    Program,
    TrainingLoop,
)
from gala_tpu_torch.ir.data_ir import (
    DataFormat,
    DataNode,
    DataOpt,
    RelDim,
    RelationEdge,
    TransformData,
    TransformEdge,
    SYM_NODES,
)


def _node(prog, loop, op_type, op, inputs, output, params=(), opts=(), layer=-1):
    cn = ComputeNode(
        op_type=op_type,
        op=op,
        inputs=list(inputs),
        outputs=[output],
        params=[str(p) for p in params],
        layer=layer,
    )
    for o, p in opts:
        cn.add_opt(o, p)
    loop.nodes.append(cn)
    for inp in inputs:
        prog.dependencies.append(RelationEdge(inp, RelDim.ALL, output, RelDim.ALL))
    return cn


def _dense(name, rows, cols):
    return DataNode(name=name, fmt=DataFormat.RM, rows=rows, cols=cols)


def _edge_data(name, spec, derived=True):
    d = DataNode(
        name=name,
        fmt=DataFormat.CSR,
        directed=not spec.graph.undirected,
        weighted=True,
        derived=derived,
        index=0,
    )
    if spec.col_tile:
        d.add_opt(DataOpt.COL_TILE, spec.col_tile)
    return d


def _aggr_opts(spec):
    opts = []
    if spec.compute.coarsen:
        opts.append((CompOpt.COARSEN, float(spec.compute.coarsen)))
    if spec.compute.sample:
        opts.append((CompOpt.SAMPLE, float(spec.compute.sample)))
    if spec.compute.sample_dynamic:
        opts.append((CompOpt.SAMPLE_DYNAMIC, float(spec.compute.sample_dynamic)))
    return opts


def generate_ir(spec: ModelSpec) -> Program:
    prog = Program(n_layers=spec.num_layers)

    # --- LOAD: graph + feature placeholders (reference: frontend.y:1035) ---
    graph = DataNode(
        name="adj0",
        fmt=DataFormat.CSR,
        directed=not spec.graph.undirected,
        weighted=not spec.graph.unweighted,
        sparser=spec.graph.sparser,
        rows=SYM_NODES,
        cols=SYM_NODES,
        index=0,
    )
    feats = _dense("t_iden", SYM_NODES, spec.graph.feat_size)
    load = ComputeNode(
        op_type=OpType.POINTWISE,
        op=ComputeOp.LOAD,
        outputs=[feats, graph],
        params=[spec.dataset],
    )
    prog.pre.append(load)
    prog.associations.append(RelationEdge(graph, RelDim.ALL, feats, RelDim.ROWS))

    # --- data transformations -> transformed graph node (frontend.y:1046) ---
    if spec.col_tile or spec.graph.sample:
        tg = graph.clone(name="graph_tile", derived=True)
        te = TransformEdge(graph, tg)
        if spec.graph.sample:
            tg.add_opt(DataOpt.SAMPLE, float(spec.graph.sample))
            te.transforms.append(TransformData(DataOpt.SAMPLE, [float(spec.graph.sample)]))
        if spec.col_tile:
            tg.add_opt(DataOpt.COL_TILE, spec.col_tile)
            te.transforms.append(TransformData(DataOpt.COL_TILE, [spec.col_tile]))
        prog.transforms.append(te)
        prog.associations.append(RelationEdge(tg, RelDim.ALL, feats, RelDim.ROWS))
        graph = tg

    loop = TrainingLoop(iters=spec.iterations, valid_step=spec.valid_step)
    prog.loop = loop

    dims = spec.layer_dims()

    # state shared across layers (degrees/norm built once, reference:
    # addLayer's `if (layerNum == 0)` guards)
    deg = norm = None
    layer_input = feats

    for li in range(spec.num_layers):
        d_in, d_out = dims[li]
        prev = layer_input
        aggr_out = res = softmax_out = None
        atten_l = atten_r = None
        ops = spec.layer_ops

        for oi, op in enumerate(ops):
            nxt = ops[oi + 1] if oi + 1 < len(ops) else None

            if op is LayerOp.GET_DEGREES:
                if li == 0:
                    if spec.compute.sample or spec.compute.sample_dynamic:
                        # sampled aggregation: degree is the sample size
                        # (reference: addDegrees_CIR FULL_OP branch)
                        deg = _dense("degrees", SYM_NODES, 1)
                        _node(
                            prog, loop, OpType.UPDATE_NODE, ComputeOp.FULL,
                            [graph], deg,
                            params=[spec.compute.sample or spec.compute.sample_dynamic],
                        )
                    else:
                        ones = _dense("ones", SYM_NODES, 1)
                        _node(prog, loop, OpType.POINTWISE, ComputeOp.ONES, [], ones)
                        deg = _dense("degrees", SYM_NODES, 1)
                        _node(
                            prog, loop, OpType.AGGREGATE_NODE,
                            ComputeOp.AGGREGATE_MUL_SUM_DIRECT,
                            [ones, graph], deg,
                            opts=_aggr_opts(spec), layer=0,
                        )

            elif op is LayerOp.GET_NORMALIZATION:
                if li == 0:
                    norm = _dense("norm", SYM_NODES, 1)
                    _node(
                        prog, loop, OpType.POINTWISE, ComputeOp.POWER,
                        [deg], norm, params=[spec.normalization_value],
                    )

            elif op is LayerOp.MULT_NORM_RES:
                sage = oi > 0 and ops[oi - 1] is LayerOp.MESSAGE_PASSING_AGGREGATE
                name = "res_n" if sage else "res"
                out = _dense(name, SYM_NODES, prev.cols)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.ROW_BROADCAST,
                      [norm, prev], out)
                prev = out

            elif op is LayerOp.MESSAGE_PASSING_AGGREGATE:
                if oi > 0 and ops[oi - 1] is LayerOp.SOFTMAX:
                    # GAT: aggregate post-FFN features with softmaxed edge vals
                    src_feats = res
                    extra = [softmax_out]
                else:
                    src_feats = prev
                    extra = []
                gin_next = nxt is LayerOp.MULT_SCALAR_FEATS
                sage_next = nxt is LayerOp.MULT_NORM_RES
                out = _dense("res_n" if (gin_next or sage_next) else "res",
                             SYM_NODES, src_feats.cols)
                _node(
                    prog, loop, OpType.AGGREGATE_NODE, ComputeOp.AGGREGATE_MUL_SUM,
                    [src_feats, graph, *extra], out,
                    opts=_aggr_opts(spec), layer=li,
                )
                aggr_out = out
                # GIN keeps layer input live for the (1+eps)*x branch
                prev = layer_input if gin_next else out

            elif op is LayerOp.FEED_FORWARD_NN:
                w = DataNode(name=f"weight{li+1}", fmt=DataFormat.CM,
                             rows=d_in if prev.cols == d_in else prev.cols,
                             cols=d_out)
                out = _dense("res", SYM_NODES, d_out)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.FFN,
                      [prev, w], out, layer=li)
                prog.associations.append(
                    RelationEdge(prev, RelDim.ROWS, w, RelDim.COLS))
                prev = res = out

            elif op is LayerOp.NON_LINEARITY:
                if spec.nonln_present[li]:
                    out = _dense("res", SYM_NODES, prev.cols)
                    _node(prog, loop, OpType.POINTWISE, ComputeOp.RELU, [prev], out)
                    prev = out

            elif op is LayerOp.ATTEN_L:
                # builds both attention heads + the SDDVV logits
                # (reference: addLayer case ATTEN_L builds L, R, then addAttn).
                # attention_heads(H) widens the per-node score vectors to
                # (N, H): head h attends feature slice [h*fh, (h+1)*fh)
                # through the ONE fused slot gather (gala_tpu_torch.ops.attention;
                # TPU extension — the reference DSL is single-head).  The
                # FINAL layer stays single-head (standard GAT: heads are
                # concatenated in hidden layers, not over class logits).
                nh = max(int(spec.attention_heads), 1)
                if li == spec.num_layers - 1:
                    nh = 1
                wl = DataNode(name=f"attenLWeight{li+1}", fmt=DataFormat.CM,
                              rows=prev.cols, cols=nh)
                al = _dense(f"attenL_{li+1}" if li else "attenL", SYM_NODES, nh)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.FFN_EDGE,
                      [prev, wl], al, layer=li)
                wr = DataNode(name=f"attenRWeight{li+1}", fmt=DataFormat.CM,
                              rows=prev.cols, cols=nh)
                ar = _dense(f"attenR_{li+1}" if li else "attenR", SYM_NODES, nh)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.FFN_EDGE,
                      [res, wr], ar, layer=li)
                atten_l, atten_r = al, ar
                attn = _edge_data("attn", spec)
                _node(prog, loop, OpType.AGGREGATE_EDGE, ComputeOp.AGGREGATE_EDGE_SUM,
                      [al, ar, graph], attn, layer=li)
                prev = attn

            elif op in (LayerOp.ATTN, LayerOp.LEAKY_RELU):
                # reference addLayer emits leaky-relu for ATTN, slope 0.2
                out = _edge_data("attn", spec)
                _node(prog, loop, OpType.UPDATE_EDGE, ComputeOp.LEAKY_RELU,
                      [prev], out, params=[0.2])
                prev = out

            elif op is LayerOp.SOFTMAX:
                out = _edge_data("attn", spec)
                _node(prog, loop, OpType.UPDATE_EDGE, ComputeOp.SOFTMAX,
                      [prev], out, layer=li)
                prev = softmax_out = out

            elif op is LayerOp.MULT_SCALAR_FEATS:
                out = _dense("res", SYM_NODES, layer_input.cols)
                _node(prog, loop, OpType.POINTWISE, ComputeOp.SCALAR_ADD_EPS_MULTIPLY,
                      [layer_input], out, params=[1], layer=li)
                prev = out

            elif op is LayerOp.ADD_SCALAR_AGGR:
                out = _dense("res", SYM_NODES, prev.cols)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.ADD,
                      [prev, aggr_out], out)
                prev = out

            elif op is LayerOp.ADD_TWO_FFN:
                # SAGE: fc(res_n) + sfc(x) (reference: add_addTwoFFN_CIR)
                w1 = DataNode(name=f"weight{li+1}", fmt=DataFormat.CM,
                              rows=prev.cols, cols=d_out)
                r1 = _dense("res_n", SYM_NODES, d_out)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.FFN,
                      [prev, w1], r1, layer=li)
                w2 = DataNode(name=f"sweight{li+1}", fmt=DataFormat.CM,
                              rows=layer_input.cols, cols=d_out)
                r2 = _dense("res", SYM_NODES, d_out)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.FFN_SELF,
                      [layer_input, w2], r2, layer=li)
                out = _dense("res", SYM_NODES, d_out)
                _node(prog, loop, OpType.UPDATE_NODE, ComputeOp.ADD,
                      [r1, r2], out)
                prev = res = out

            else:  # pragma: no cover - SAGE_OPS/ATTEN_R are expanded upstream
                raise ValueError(f"unexpected layer op {op}")

        layer_input = prev

    return prog
