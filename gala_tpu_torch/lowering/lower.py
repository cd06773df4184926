"""Lowering: ModelSpec -> optimized IR -> executable CompiledModel (the
port of gala_tpu.lowering.lower).

The same stages as gala_tpu (dataset, input-aware schedule, IR, the
middle-end passes, data-level and static kernel sampling, the bell_order
relabel, training subgraphs); the "emitted program" is an eager PyTorch
training loop on one device.  Dynamic kernel sampling builds every graph
with its sampling inputs (Graph.from_host(dynamic_sample=True)), and
CompiledModel.train feeds each epoch its (ra, rb).  The schedule's
col_tile directive reaches every graph as column tiling
(Graph.from_host(col_tile=)), honoured as written: gala_tpu's TPU memory
gate, which drops a tile below its flat-intermediate budget, has nothing
to budget here.  use_long (or the spec's) builds the full graph with
int64 edge ids (Graph.from_host(long_indices=True)), as gala_tpu does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gala_tpu_torch.data.datasets import load_dataset
from gala_tpu_torch.data.sampling import dynamic_sample_params, sample_graph_ab
from gala_tpu_torch.data.subgraph import mask_subgraphs
from gala_tpu_torch.dsl.spec import ModelSpec
from gala_tpu_torch.ir.build import generate_ir
from gala_tpu_torch.ir.compute_ir import Program, uses_edge_values, uses_fused_attention
from gala_tpu_torch.ir.data_ir import SYM_CLASSES, SYM_FEATS
from gala_tpu_torch.lowering.autoschedule import autoschedule
from gala_tpu_torch.lowering.interp import make_forward, make_init_params
from gala_tpu_torch.models.common import activation_dtype
from gala_tpu_torch.ops.graph import NODE_PAD, Graph, choose_strategy
from gala_tpu_torch.passes.pipeline import run_passes
from gala_tpu_torch.train import TrainResult, train


@dataclasses.dataclass
class CompiledModel:
    """A compiled GNN program bound to a dataset on one device: the analog
    of the reference's generated `./gala_model` executable."""

    spec: ModelSpec
    program: Program
    full_graphs: list
    train_graphs: list | None
    x: torch.Tensor
    labels: torch.Tensor
    train_mask: torch.Tensor
    test_mask: torch.Tensor
    init_params: object
    invariant: object
    forward: object
    n_classes: int
    device: torch.device
    forward_rows: object = None  # row-subset loss variant (see interp)

    def make_params(self, seed: int = 0):
        dim_env = {
            SYM_FEATS: int(self.x.shape[1]),
            SYM_CLASSES: self.n_classes,
        }
        gen = torch.Generator().manual_seed(seed)
        return self.init_params(gen, dim_env).to(self.device)

    def train(self, iters: int | None = None, seed: int = 0, params=None,
              **kw) -> TrainResult:
        """Train from `params` (updated in place) or from fresh
        make_params(seed) weights.  A dynamically sampled program draws
        epoch e's (ra, rb) from dynamic_sample_params(e, seed) unless
        `epoch_inputs` is given."""
        if params is None:
            params = self.make_params(seed)
        loop = self.program.loop
        if self.spec.compute.sample_dynamic and "epoch_inputs" not in kw:
            def epoch_inputs(epoch):
                ra, rb = dynamic_sample_params(epoch, seed)
                return {"_ra": ra, "_rb": rb}

            kw["epoch_inputs"] = epoch_inputs
        if self.forward_rows is not None:
            # training loss on train-mask rows only: the classifier FFN
            # and (N, C) logits shrink to the mask fraction
            def rows_of(mask):
                m = mask.cpu().numpy()
                idx = np.flatnonzero(m)
                if not idx.size:
                    return None
                # pad with the last padding row (Graph.from_host always
                # reserves >= 1 phantom row, whose mask is False)
                pad = (-idx.size) % 8
                if m[-1]:
                    raise ValueError("no phantom row at the end of the mask")
                idx = np.concatenate([idx, np.full(pad, m.shape[0] - 1, idx.dtype)])
                return torch.from_numpy(idx.astype(np.int64)).to(self.device)

            tr = rows_of(self.train_mask)
            if tr is not None:
                kw.update(train_rows=tr, forward_rows=self.forward_rows,
                          test_rows=rows_of(self.test_mask))
        return train(
            self.forward,
            params,
            self.full_graphs,
            self.x,
            self.labels,
            self.train_mask,
            self.test_mask,
            iters=iters if iters is not None else loop.iters,
            valid_step=loop.valid_step or 5,
            lr=loop.lr,
            weight_decay=loop.weight_decay,
            train_graphs=self.train_graphs,
            invariant=self.invariant,
            measure_memory=self.spec.print_memory,
            **kw,
        )

    def run(self, iters: int | None = None) -> str:
        """Train and return the reference's stdout CSV line."""
        res = self.train(iters=iters)
        return res.csv(self.spec.print_accuracy, self.spec.print_memory)


def lower(
    spec: ModelSpec,
    mode: str = "train",
    data=None,
    data_root: str | None = None,
    strategy: str = "auto",
    scale: float = 1.0,
    seed: int = 0,
    dtype=None,
    use_long: bool = False,
    device="cuda",
) -> CompiledModel:
    """Compile a parsed spec into an executable model on `device` (the
    card unless the caller asks for "cpu").

    data: optional (HostCSR, feats, labels, masks) tuple; otherwise the
    dataset named in the DSL is resolved via the registry.
    mode: 'train' or 'inference' (which passes run, as in the reference).
    dtype: the activations' dtype, torch.bfloat16 for gala_tpu's mixed
    precision (the padded features cast to it; params and the loss f32).
    use_long: int64 edge ids on the full graph (the inference_long driver).
    """
    dtype = activation_dtype(dtype)
    device = torch.device(device)

    # ---- dataset ---------------------------------------------------- #
    if data is None:
        data = load_dataset(spec.dataset, data_root=data_root, scale=scale, seed=seed)
    g_host, feats, labels, masks = data
    n_classes = int(labels.max()) + 1

    # ---- input-aware schedule --------------------------------------- #
    if spec.opt_input is not None:
        autoschedule(spec, g_host, feats.shape[1], n_classes)
    # the bound dataset always wins over declared sizes
    spec.graph.feat_size = int(feats.shape[1])
    spec.graph.label_size = n_classes
    if spec.output_sizes:
        spec.output_sizes[-1] = n_classes

    # ---- IR + middle-end passes ------------------------------------- #
    prog = generate_ir(spec)
    prog = run_passes(prog, spec, mode=mode)

    # ---- data-level transformations --------------------------------- #
    # data sampling, and static kernel sampling lowered to the same
    # fixed-degree resample (data.sampling: the picks of (5, 7))
    if spec.graph.sample:
        g_host = sample_graph_ab(g_host, int(spec.graph.sample))
    elif spec.compute.sample:
        g_host = sample_graph_ab(g_host, int(spec.compute.sample))
    dynamic = bool(spec.compute.sample_dynamic)
    # graphs with learned per-edge values (the unfused GAT chain, the
    # sparse rewrite's precomputed values) need the edge lists and, above
    # the dense gate, the row-split ELL's slot -> edge-id permutation;
    # unless the attention chain was fused into the slot-space op
    edge_vals = uses_edge_values(prog)
    attention = uses_fused_attention(prog)
    nh = max(int(getattr(spec, "attention_heads", 1)), 1)
    if nh > 1:
        # multi-head rides the fused op's shared slot sweep; the unfused
        # SDDVV/softmax chain is (N, 1)-shaped
        if not attention:
            raise ValueError(
                "attention_heads > 1 requires the fused attention path "
                "(enable the attention_fusion pass / use a standard GAT "
                "layer body)"
            )
        # final layer stays single-head (see ir/build ATTEN_L)
        bad = [d for d in spec.output_sizes[:-1] if d % nh]
        if bad:
            raise ValueError(
                f"attention_heads={nh} must divide every hidden GAT layer "
                f"width; offending sizes: {bad}"
            )

    if strategy == "auto":
        strategy = choose_strategy(g_host.n_rows + NODE_PAD, g_host.n_cols + NODE_PAD,
                                   g_host.n_edges, edge_vals=edge_vals)
    if strategy in ("bell", "pallas_bell"):
        # relabel nodes in degree-class order so the binned layout's
        # output order is the identity (no reorder at run time); fused
        # attention keeps self loops as slots, so its class order is
        # computed without the diagonal split; so do dynamic-sampling
        # bells (slot position must equal CSR position)
        from gala_tpu_torch.data.ell import bell_order
        from gala_tpu_torch.data.reordering import apply_reorder

        order = bell_order(g_host, split_diag=not attention and not dynamic)
        g_host, feats, labels, masks, _ = apply_reorder(
            g_host, order, feats, labels, masks
        )

    col_tile = spec.col_tile or None
    full_g = Graph.from_host(g_host, strategy=strategy, undirected=spec.graph.undirected,
                             device=device, edge_vals=edge_vals, attention=attention,
                             dynamic_sample=dynamic, col_tile=col_tile,
                             long_indices=bool(use_long or spec.use_long))
    n_layers = spec.num_layers
    full_graphs = [full_g] * n_layers

    train_graphs = None
    if prog.uses_training_subgraphs:
        subs = mask_subgraphs(g_host, masks["train"], n_layers)
        train_graphs = [
            Graph.from_host(s, strategy=strategy, undirected=False, device=device,
                            edge_vals=edge_vals, attention=attention, dynamic_sample=dynamic,
                            col_tile=col_tile)
            for s in subs
        ]

    x = full_g.pad_nodes(np.asarray(feats, np.float32))
    if dtype is not None:
        # mixed precision: bf16 activations, f32 params and loss (gala_tpu's)
        x = x.to(dtype)
    y = full_g.pad_nodes(np.asarray(labels, np.int64))
    tm = full_g.pad_nodes(np.asarray(masks["train"], bool))
    sm = full_g.pad_nodes(np.asarray(masks["test"], bool))

    invariant, forward, forward_rows = make_forward(prog)

    return CompiledModel(
        spec=spec,
        program=prog,
        full_graphs=full_graphs,
        train_graphs=train_graphs,
        x=x,
        labels=y,
        train_mask=tm,
        test_mask=sm,
        init_params=make_init_params(prog),
        invariant=invariant,
        forward=forward,
        forward_rows=forward_rows,
        n_classes=spec.graph.label_size if spec.graph.label_size > 0 else n_classes,
        device=device,
    )
