"""The GAT paper's multi-head model in the port's DSL: `gat_heads(H, out=K);`
and `dsl.non_ln.ELU`.

The DSL front end, the IR and the passes (dsl/, ir/, passes/) are
gala_tpu's, copied verbatim, so the port extends them from outside:

- `parse_source` takes the `gat_heads` statement out of the source, hands
  the rest to the copied parser and returns a `HeadsSpec`, the copied
  ModelSpec with three more fields, where the source asks for either
  form; any other source gets the copied parser's ModelSpec untouched.
- `rewrite` turns the IR that generate_ir builds for the DSL's one-head
  GAT layer into the paper's form, before the passes run: every hidden
  GAT layer has H heads of its DSL width F' (the FFN H F' wide), head h
  scored from its own F' columns by attenLWeight{i} / attenRWeight{i} of
  shape (F', H) plus (H,) (FFN_EDGE nodes marked with their heads), the
  heads concatenated; the last layer has K heads of the class count and a
  mean over them after its aggregation (a TRANSFORM node, "head_mean").
  With ELU, each ReLU node becomes a TRANSFORM node, "elu".
- `check` holds what the form runs on; lowering.lower calls it.

lowering.interp evaluates the marked nodes (ops.attention's head_scores,
head_mean and elu).  Sources without the two statements compile as
before: the same IR, parameters and launches.
"""
from __future__ import annotations

import dataclasses
import re

from gala_tpu_torch.dsl import parser
from gala_tpu_torch.dsl.spec import ModelSpec
from gala_tpu_torch.ir.compute_ir import ComputeNode, ComputeOp, OpType, Program
from gala_tpu_torch.ir.data_ir import SYM_NODES, DataFormat, DataNode, RelDim, RelationEdge

STRATEGIES = ("bell", "pallas_bell", "dense")
_STATEMENT = re.compile(r"(?<![\w.])gat_heads\s*\(([^)]*)\)\s*;?")
_ARGS = re.compile(r"^\s*(\d+)\s*(?:,\s*out\s*=\s*(\d+)\s*)?$")
_ELU = re.compile(r"non_ln\s*\.\s*ELU\b")


@dataclasses.dataclass
class HeadsSpec(ModelSpec):
    """A ModelSpec with the GAT paper's heads and the model's non-linearity.

    gat_heads: H heads in every hidden GAT layer (0: the DSL's one-head
    GAT); gat_out_heads: K heads in the last layer, averaged;
    nonlinearity: "elu" (dsl.non_ln.ELU) or "relu" (any other name)."""

    gat_heads: int = 0
    gat_out_heads: int = 1
    nonlinearity: str = "relu"

    def heads_of(self, layer: int) -> int:
        """Heads of `layer` (1 without gat_heads)."""
        if not self.gat_heads:
            return 1
        return self.gat_out_heads if layer == self.num_layers - 1 else self.gat_heads


def parse_source(source: str) -> ModelSpec:
    """The copied parser's spec of `source`, a HeadsSpec where it holds a
    `gat_heads(H[, out=K]);` statement (K defaults to 1) or names
    dsl.non_ln.ELU.  Raises DSLSyntaxError on a malformed gat_heads."""
    src = parser._strip_comments(source)
    heads = []
    for m in _STATEMENT.finditer(src):
        args = _ARGS.match(m.group(1))
        if not args or not int(args.group(1)) or (args.group(2) and not int(args.group(2))):
            raise parser.DSLSyntaxError(f"gat_heads takes H >= 1 heads and out=K >= 1: "
                                        f"{m.group(0)!r}")
        heads.append((int(args.group(1)), int(args.group(2) or 1)))
    elu = bool(_ELU.search(src))
    spec = parser.parse_source(_STATEMENT.sub("", src))
    if not heads and not elu:
        return spec
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(ModelSpec)}
    h, k = heads[-1] if heads else (0, 1)
    return HeadsSpec(**fields, gat_heads=h, gat_out_heads=k,
                     nonlinearity="elu" if elu else "relu")


def parse_file(path: str) -> ModelSpec:
    with open(path) as f:
        return parse_source(f.read())


def _edge(prog: Program, src: DataNode, dst: DataNode) -> None:
    prog.dependencies.append(RelationEdge(src, RelDim.ALL, dst, RelDim.ALL))


def rewrite(prog: Program, spec: HeadsSpec) -> Program:
    """generate_ir's program in the paper's form (module docstring); the
    widths are set along the loop in order, each FFN reading its input's."""
    if spec.gat_heads:
        if not any(n.op is ComputeOp.FFN_EDGE for n in prog.loop.nodes):
            raise ValueError("gat_heads applies to a GAT layer body (attention scores by "
                             "dsl.nn.ffn(res, out=1), an edge softmax and an aggregation)")
        if spec.attention_heads > 1:
            raise ValueError("gat_heads and attention_heads are two forms of heads; use one")
    nodes = prog.loop.nodes
    last = spec.num_layers - 1
    heads = 1
    for node in list(nodes):
        if node.layer >= 0:
            heads = spec.heads_of(node.layer)
        out = node.outputs[0]
        if spec.gat_heads and node.op in (ComputeOp.FFN, ComputeOp.FFN_EDGE):
            x, w = node.inputs
            if node.op is ComputeOp.FFN:
                if w.cols <= 0 and heads > 1:
                    raise ValueError(f"gat_heads needs the width of layer {node.layer} known: "
                                     "bind a dataset (compile with data) or give label_size(C)")
                w.rows, w.cols = x.cols, w.cols * heads
            else:  # head h's score from its own w.rows = F' columns
                w.cols = heads
                node.params = [str(heads)]
            out.cols = w.cols
        elif spec.gat_heads and node.op is ComputeOp.AGGREGATE_MUL_SUM:
            out.cols = node.inputs[0].cols
            if node.layer == last and heads > 1 and len(node.inputs) >= 3:
                mean = DataNode(name="res", fmt=DataFormat.RM, rows=SYM_NODES,
                                cols=out.cols // heads)
                for later in nodes[nodes.index(node) + 1:]:
                    later.inputs = [mean if d is out else d for d in later.inputs]
                nodes.insert(nodes.index(node) + 1, ComputeNode(
                    op_type=OpType.UPDATE_NODE, op=ComputeOp.TRANSFORM, inputs=[out],
                    outputs=[mean], params=["head_mean", str(heads)], layer=node.layer))
                _edge(prog, out, mean)
        elif node.op is ComputeOp.RELU:
            out.cols = node.inputs[0].cols
            if spec.nonlinearity == "elu":
                node.op, node.params = ComputeOp.TRANSFORM, ["elu", str(heads)]
    return prog


def check(spec: HeadsSpec, attention: bool, strategy: str) -> None:
    """What the GAT-form heads run on: the fused attention chain, on the
    attention kernels ('bell') or head by head ('dense'), at 1 to
    MAX_HEADS heads a layer, on one device."""
    from gala_tpu_torch.ops.kernels.attn_bell import MAX_HEADS

    if not spec.gat_heads:
        return
    if not attention:
        raise ValueError("gat_heads requires the fused attention path (the attention_fusion "
                         "pass on a standard GAT layer body)")
    heads = [spec.heads_of(li) for li in range(spec.num_layers)]
    if max(heads) > MAX_HEADS:
        raise ValueError(f"gat_heads takes 1 to {MAX_HEADS} heads a layer (the attention "
                         f"kernels' limit), got {heads}")
    if strategy not in STRATEGIES:
        raise ValueError(f"gat_heads runs on strategies {STRATEGIES}, not {strategy!r}")
