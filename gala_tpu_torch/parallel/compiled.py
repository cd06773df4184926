"""Sharded execution of DSL-compiled programs (the port of
gala_tpu.parallel.compiled).

Runs any compiled GALA program over a process mesh: every rank runs the
program's own interpreter (gala_tpu_torch.lowering.interp) on its
ShardGraph and its node rows, and the op layer dispatches the sharded
graph to parallel.ops, so the single-device program and the sharded one
are the same program at the IR level.  Nodes are range-partitioned over
the mesh's 'data' axis (features, labels, masks and destination rows
together); remote sources arrive by all_gather or a halo all_to_all;
parameters are replicated over 'data' (their gradients all-reduced after
each backward) and, with a 'model' axis, split by the TP plan
(parallel.tp).

Called in every rank of the mesh, with the same arguments:

    import gala_tpu_torch
    from gala_tpu_torch.parallel.compiled import shard_compiled
    from gala_tpu_torch.parallel.mesh import make_mesh
    cm = gala_tpu_torch.compile_file("model.txt", mode="train")
    sm = shard_compiled(cm, make_mesh(backend="nccl"), use_bell=True)
    res = sm.train(iters=100)        # TrainResult, the same protocol
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gala_tpu_torch.ir.compute_ir import uses_edge_values, uses_fused_attention
from gala_tpu_torch.ir.data_ir import SYM_CLASSES, SYM_FEATS
from gala_tpu_torch.models.common import activation_dtype
from gala_tpu_torch.parallel.graph import ShardedGraph
from gala_tpu_torch.parallel.mesh import Mesh, make_mesh
from gala_tpu_torch.parallel.tp import plan_tp
from gala_tpu_torch.train import TrainResult, train
from gala_tpu_torch.weights import params_to_numpy, shard_params


@dataclasses.dataclass
class SpmdCompiled:
    """A compiled model resharded over a mesh, as one rank sees it;
    mirrors CompiledModel's training surface.  Node tensors are this
    rank's rows_per_shard rows; `forward` returns this rank's logits."""

    cm: object                  # the underlying CompiledModel
    mesh: Mesh
    full_graphs: list           # this rank's ShardGraph per layer
    train_graphs: list | None
    x: torch.Tensor
    labels: torch.Tensor
    train_mask: torch.Tensor
    test_mask: torch.Tensor
    plan: dict | None           # the TP plan (parallel.tp), None: replicated
    forward: object
    invariant: object

    def make_params(self, seed: int = 0):
        """The compiled model's make_params(seed), this rank's slices."""
        return shard_params(params_to_numpy(self.cm.make_params(seed)), self.plan, self.mesh)

    def train(self, iters: int | None = None, seed: int = 0, params=None, **kw) -> TrainResult:
        """The port's train() protocol over the mesh's data group, from
        `params` (this rank's, updated in place) or make_params(seed)."""
        if params is None:
            params = self.make_params(seed)
        loop = self.cm.program.loop
        return train(
            self.forward,
            params,
            self.full_graphs,
            self.x,
            self.labels,
            self.train_mask,
            self.test_mask,
            iters=iters if iters is not None else (loop.iters if loop else 100),
            valid_step=loop.valid_step if loop else 5,
            train_graphs=self.train_graphs,
            invariant=self.invariant,
            group=self.mesh.data_group,
            **kw,
        )


def shard_compiled(
    cm,
    mesh: Mesh | None = None,
    use_halo: bool = False,
    use_bell: bool = False,
    dtype=None,
    tp: bool = True,
) -> SpmdCompiled:
    """Reshard a CompiledModel over `mesh` (default: every rank on a
    1-axis 'data' mesh, make_mesh()), as this rank's share; every rank
    calls it.

    use_halo: exchange only boundary rows by all_to_all instead of
    all_gathering the feature matrix for each aggregation.
    use_bell: the rank's binned layouts run the SpMM kernel (and, for a
    fused-attention program, the attention kernels; for learned edge
    values, the SpMM with per-slot values and the SDDMM kernel); implies
    use_halo (parallel.graph).
    dtype: the activations' dtype (torch.bfloat16: gala_tpu's mixed
    precision).
    tp: with a 'model' axis > 1, the Megatron col/row FFN splits that
    parallel.tp.plan_tp finds in the IR; a program it cannot split keeps
    replicated parameters."""
    if cm.host_graph is None:
        raise ValueError("CompiledModel lacks host data; re-run lower()")
    if cm.spec.compute.sample_dynamic:
        raise NotImplementedError("dynamic sampling is single-chip only")
    if getattr(cm.spec, "gat_heads", 0):
        raise NotImplementedError("gat_heads programs are single-chip only")
    mesh = mesh or make_mesh(model_axis=1)
    n_shards = mesh.shape["data"]
    shard = mesh.coords[0]

    bell_kw = dict(use_halo=use_halo, use_bell=use_bell,
                   attention=uses_fused_attention(cm.program),
                   edge_vals=uses_edge_values(cm.program))
    sg = ShardedGraph.from_host(cm.host_graph, n_shards, **bell_kw)

    n_model = mesh.shape["model"]
    dim_env = {SYM_FEATS: int(np.asarray(cm.host_feats).shape[1]), SYM_CLASSES: cm.n_classes}
    plan = plan_tp(cm.program, dim_env, n_model) if tp else None

    def local(s: ShardedGraph):
        g = s.local(shard, mesh.device, mesh.data_group)
        return dataclasses.replace(g, tp_plan=plan, model_group=mesh.model_group) if plan else g

    full = local(sg)
    full_graphs = [full] * cm.spec.num_layers
    train_graphs = None
    if cm.host_train_graphs is not None:
        train_graphs = [local(ShardedGraph.from_host(s, n_shards, **bell_kw))
                        for s in cm.host_train_graphs]

    def put(arr, dtype_=None):
        t = torch.from_numpy(np.ascontiguousarray(sg.rows_of(arr, shard))).to(mesh.device)
        return t if dtype_ is None else t.to(dtype_)

    return SpmdCompiled(
        cm=cm,
        mesh=mesh,
        full_graphs=full_graphs,
        train_graphs=train_graphs,
        x=put(np.asarray(cm.host_feats, np.float32), activation_dtype(dtype)),
        labels=put(np.asarray(cm.host_labels, np.int64)),
        train_mask=put(np.asarray(cm.host_masks["train"], bool)),
        test_mask=put(np.asarray(cm.host_masks["test"], bool)),
        plan=plan,
        forward=cm.forward,
        invariant=cm.invariant,
    )
