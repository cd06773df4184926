"""Lowering: ModelSpec -> optimized IR -> executable CompiledModel (the
port of gala_tpu.lowering.lower).

The same stages as gala_tpu (dataset, input-aware schedule, IR, the
middle-end passes, the bell_order relabel, training subgraphs); the
"emitted program" is an eager PyTorch training loop on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gala_tpu_torch.data.datasets import load_dataset
from gala_tpu_torch.data.subgraph import mask_subgraphs
from gala_tpu_torch.dsl.spec import ModelSpec
from gala_tpu_torch.ir.build import generate_ir
from gala_tpu_torch.ir.compute_ir import Program, uses_edge_values, uses_fused_attention
from gala_tpu_torch.ir.data_ir import SYM_CLASSES, SYM_FEATS
from gala_tpu_torch.lowering.autoschedule import autoschedule
from gala_tpu_torch.lowering.interp import make_forward, make_init_params
from gala_tpu_torch.ops.graph import NODE_PAD, Graph, choose_strategy, not_ported
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
        make_params(seed) weights."""
        if params is None:
            params = self.make_params(seed)
        loop = self.program.loop
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
    device="cpu",
) -> CompiledModel:
    """Compile a parsed spec into an executable model on `device`.

    data: optional (HostCSR, feats, labels, masks) tuple; otherwise the
    dataset named in the DSL is resolved via the registry.
    mode: 'train' or 'inference' (which passes run, as in the reference).
    """
    if dtype is not None and dtype not in (torch.float32, np.float32, "float32"):
        raise not_ported(f"dtype {dtype}", "ROADMAP Queue 1 item 5 (bf16 activations)")
    if use_long or spec.use_long:
        raise not_ported("int64 edge indices", "ROADMAP Queue 1 item 9")
    device = torch.device(device)

    # ---- dataset ---------------------------------------------------- #
    if data is None:
        data = load_dataset(spec.dataset, data_root=data_root, scale=scale, seed=seed)
    g_host, feats, labels, masks = data
    n_classes = int(labels.max()) + 1

    # ---- input-aware schedule --------------------------------------- #
    if spec.opt_input is not None:
        autoschedule(spec, g_host, feats.shape[1], n_classes)
    if spec.col_tile:
        raise not_ported("the col_tile directive", "ROADMAP Queue 1 item 9")
    # the bound dataset always wins over declared sizes
    spec.graph.feat_size = int(feats.shape[1])
    spec.graph.label_size = n_classes
    if spec.output_sizes:
        spec.output_sizes[-1] = n_classes

    # ---- IR + middle-end passes ------------------------------------- #
    prog = generate_ir(spec)
    prog = run_passes(prog, spec, mode=mode)

    if spec.graph.sample or spec.compute.sample or spec.compute.sample_dynamic:
        raise not_ported("graph sampling", "ROADMAP Queue 1 item 8")
    if uses_edge_values(prog) or uses_fused_attention(prog):
        raise not_ported("attention (learned edge values)", "ROADMAP Queue 1 item 7")

    if strategy == "auto":
        strategy = choose_strategy(g_host.n_rows + NODE_PAD, g_host.n_cols + NODE_PAD)
    if strategy == "bell":
        # relabel nodes in degree-class order so the binned layout's
        # output order is the identity (no reorder at run time)
        from gala_tpu_torch.data.ell import bell_order
        from gala_tpu_torch.data.reordering import apply_reorder

        order = bell_order(g_host, split_diag=True)
        g_host, feats, labels, masks, _ = apply_reorder(
            g_host, order, feats, labels, masks
        )

    full_g = Graph.from_host(g_host, strategy=strategy,
                             undirected=spec.graph.undirected, device=device)
    n_layers = spec.num_layers
    full_graphs = [full_g] * n_layers

    train_graphs = None
    if prog.uses_training_subgraphs:
        subs = mask_subgraphs(g_host, masks["train"], n_layers)
        train_graphs = [
            Graph.from_host(s, strategy=strategy, undirected=False, device=device)
            for s in subs
        ]

    x = full_g.pad_nodes(np.asarray(feats, np.float32))
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
