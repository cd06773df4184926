"""Middle-end pass pipeline with per-driver defaults.

The reference ships five near-identical driver CLIs that differ in which
passes run (reference: tests/gala_inference.cpp:174-187 runs reorder +
sparse rewrites; tests/gala_train.cpp:137-146 adds TIM-aware reordering,
code motion and training subgraphs).  Here one function applies the same
matrix, gated by the DSL's pass flags (PassFlags) and the compile mode.
"""
from __future__ import annotations

from gala_tpu_torch.dsl.spec import ModelSpec
from gala_tpu_torch.ir.compute_ir import Program
from gala_tpu_torch.passes.code_motion import training_invariant_code_motion
from gala_tpu_torch.passes.reorder import operator_reordering
from gala_tpu_torch.passes.sparsify import ffn_recompute_rewrites, sparsity_aware_rewrites
from gala_tpu_torch.passes.subgraph import training_subgraph


def run_passes(prog: Program, spec: ModelSpec, mode: str = "train") -> Program:
    """mode: 'train' (all four passes) or 'inference' (first two).

    The training drivers run reordering in TIM mode so the loop-invariant
    prefix stays maximal."""
    train = mode == "train"
    if spec.passes.operator_reordering:
        prog = operator_reordering(prog, enable_tim=train and spec.passes.train_code_motion)
    if spec.passes.sparse_rewrites:
        prog = sparsity_aware_rewrites(prog)
        from gala_tpu_torch.ir.data_ir import SYM_CLASSES, SYM_FEATS

        prog = ffn_recompute_rewrites(prog, {
            SYM_FEATS: spec.graph.feat_size,
            SYM_CLASSES: spec.graph.label_size,
        })
    if train and spec.passes.train_code_motion:
        prog = training_invariant_code_motion(prog)
    if train and spec.passes.training_subgraph:
        prog = training_subgraph(prog)
    if getattr(spec.passes, "attention_fusion", True):
        from gala_tpu_torch.passes.attention_fusion import attention_fusion

        prog = attention_fusion(prog)
    return prog
