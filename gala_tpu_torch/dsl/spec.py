"""ModelSpec: the parsed model + schedule configuration.

Clean-room equivalent of the reference's `ModelConfig`
(reference: src/ir/frontend_metadata.h:46-165) plus the frontend context
flags (reference: src/frontend/context.h:18-34).  Produced by the text
parser (gala_tpu_torch.dsl.parser) or the Python-embedded builder
(gala_tpu_torch.dsl.builder); consumed by gala_tpu_torch.ir.build.generate_ir.
"""
from __future__ import annotations

import dataclasses
import enum


class LayerOp(enum.Enum):
    # reference: src/ir/frontend_metadata.h:9-25 (LayerOpType)
    GET_DEGREES = "get_degrees"
    GET_NORMALIZATION = "get_normalization"
    MULT_NORM_RES = "mult_norm_res"
    MESSAGE_PASSING_AGGREGATE = "aggregate"
    FEED_FORWARD_NN = "ffn"
    ADD_TWO_FFN = "add_two_ffn"
    NON_LINEARITY = "non_linearity"
    ATTEN_L = "atten_l"
    ATTEN_R = "atten_r"
    ATTN = "attn"
    LEAKY_RELU = "leaky_relu"
    SAGE_OPS = "sage_ops"
    SOFTMAX = "softmax"
    MULT_SCALAR_FEATS = "mult_scalar_feats"
    ADD_SCALAR_AGGR = "add_scalar_aggr"


@dataclasses.dataclass
class GraphSchedule:
    """Graph transformations (reference: GraphTransformType map defaults
    in ModelConfig's constructor)."""

    undirected: bool = True
    unweighted: bool = True
    sparser: bool = False
    sample: int = 0             # data-level neighbor sampling size
    feat_size: int = -2         # SYM_FEATS until known
    label_size: int = -3        # SYM_CLASSES until known


@dataclasses.dataclass
class ComputeSchedule:
    """Compute transformations (reference: ComputeTransformType)."""

    coarsen: int = 0            # register/VMEM coarsening factor -> block shape hint
    sample: int = 0             # kernel-level static sampling
    sample_dynamic: int = 0     # kernel-level per-epoch sampling


@dataclasses.dataclass
class PassFlags:
    """Middle-end pass toggles (reference: GALAFEContext flags +
    per-driver defaults, tests/gala_train.cpp:137-146)."""

    operator_reordering: bool = True
    sparse_rewrites: bool = True
    training_subgraph: bool = True
    train_code_motion: bool = True
    # TPU-specific pass: fuse the GAT edge-softmax chain into a single
    # slot-space op (gala_tpu_torch.passes.attention_fusion)
    attention_fusion: bool = True


@dataclasses.dataclass
class ModelSpec:
    dataset: str = ""
    iterations: int = 0
    valid_step: int = 0
    num_layers: int = 0
    layer_ops: list[LayerOp] = dataclasses.field(default_factory=list)
    nonln_present: list[bool] = dataclasses.field(default_factory=list)
    output_sizes: list[int] = dataclasses.field(default_factory=list)
    normalization_value: float = -1.0
    graph: GraphSchedule = dataclasses.field(default_factory=GraphSchedule)
    compute: ComputeSchedule = dataclasses.field(default_factory=ComputeSchedule)
    col_tile: float = 0.0        # data transformation (COL_TILE segment size)
    passes: PassFlags = dataclasses.field(default_factory=PassFlags)
    opt_input: str | None = None   # input-aware compilation data path
    print_accuracy: bool = False
    print_memory: bool = False
    use_long: bool = False         # int64 indices (papers100M-scale)
    # GAT attention heads (TPU extension; the reference DSL is
    # single-head).  Heads ride as extra feature columns of the ONE
    # fused slot gather (gala_tpu_torch.ops.attention) — requires the
    # attention_fusion pass and head-divisible layer widths.
    attention_heads: int = 1

    def layer_dims(self) -> list[tuple[int, int]]:
        """Per-layer (d_in, d_out), resolving the last layer to label_size
        (the reference's output_input_classes + FEAT/LABEL_SIZE logic,
        reference: src/frontend/frontend.y addFFN_CIR)."""
        dims = []
        d_in = self.graph.feat_size
        for i in range(self.num_layers):
            d_out = (
                self.graph.label_size
                if i == self.num_layers - 1
                else self.output_sizes[i]
            )
            dims.append((d_in, d_out))
            d_in = d_out
        return dims
