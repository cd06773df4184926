"""Training loop: Adam + cross-entropy on the train mask, timed epochs (the
port of gala_tpu.train).

- optimizer: torch.optim.Adam(lr, weight_decay=5e-4): L2 added to the
  gradient before the moment update, the rule gala_tpu builds with
  optax.chain(add_decayed_weights, adam).
- loss: cross-entropy over train-mask rows only.
- timing: the first `warmup` epochs are left out of the means.  A
  training phase (forward, backward, step) is followed by a forward-only
  inference phase over the same graph schedule; each phase is bracketed
  by one synchronize at each end, never one inside an epoch.
- validation: every `valid_step` epochs the step runs on the full graphs;
  the other epochs run on the per-layer training subgraphs when given.
  Test accuracy is evaluated after the timed regions, from snapshots of
  the parameters taken at the validation epochs.

gala_tpu's XLA devices (lax.scan epoch chunks, the anti-hoisting bump,
the compile warm-up pool, host-fetch fences) have no counterpart here:
PyTorch runs each epoch eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.utils.timing import EpochTimer


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over mask rows (mask includes padding=False rows)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    m = mask.to(logp.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    pred = logits.argmax(dim=-1)
    m = mask.to(torch.float32)
    return ((pred == labels).to(torch.float32) * m).sum() / m.sum().clamp_min(1.0)


def make_optimizer(params: nn.Module, lr: float = 0.01, weight_decay: float = 5e-4):
    """torch Adam(lr, weight_decay): L2 added to grads, then Adam (NOT
    decoupled AdamW) — the reference's generated optimizer."""
    return torch.optim.Adam(params.parameters(), lr=lr, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainResult:
    inference_time: float   # mean fwd seconds/epoch (post warmup)
    total_time: float       # mean fwd+bwd+step seconds/epoch
    max_accuracy: float     # max test accuracy over validation epochs
    losses: list
    accuracies: list
    params: object
    memory_mb: float = 0.0

    def csv(self, print_accuracy: bool = False, print_memory: bool = False) -> str:
        """The reference's stdout CSV contract."""
        if print_memory:
            return f"{self.memory_mb},{self.inference_time},{self.total_time}"
        if print_accuracy:
            return f"{self.inference_time},{self.total_time},{self.max_accuracy}"
        return f"{self.inference_time},{self.total_time}"


def device_memory_mb(device) -> float:
    """Peak device memory allocated by PyTorch on `device`, in MB (0.0 on
    the CPU, which has no device memory to report)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device) / 1e6
    return 0.0


def _snapshot(params: nn.Module) -> dict:
    return {name: {k: v.detach().clone() for k, v in layer.items()}
            for name, layer in params.items()}


def train(
    forward: Callable,
    params: nn.Module,
    full_graphs: Sequence[Graph],
    x,
    labels: torch.Tensor,
    train_mask: torch.Tensor,
    test_mask: torch.Tensor,
    iters: int = 100,
    valid_step: int = 5,
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    warmup: int = 5,
    train_graphs: Sequence[Graph] | None = None,
    invariant: Callable | None = None,
    measure_memory: bool = False,
    forward_rows: Callable | None = None,
    train_rows: torch.Tensor | None = None,
    test_rows: torch.Tensor | None = None,
) -> TrainResult:
    """Run the full training protocol and return timing/accuracy stats.

    forward(params, graphs, x) -> logits (n_pad, n_classes)
    invariant: optional hoisted prefix fn(graphs, x) -> carry, run once
        outside the loop (training-invariant code motion product).
    train_graphs: per-layer training subgraphs; when given, non-validation
        epochs aggregate over them instead of the full graph.
    `params` is updated in place and returned in the result."""
    device = full_graphs[0].device
    opt = make_optimizer(params, lr, weight_decay)

    with torch.no_grad():
        if invariant is not None:
            x_train = invariant(train_graphs if train_graphs is not None else full_graphs, x)
            x_full = invariant(full_graphs, x) if train_graphs is not None else x_train
        else:
            x_train = x_full = x
    use_sub = train_graphs is not None
    gs_train = train_graphs if use_sub else full_graphs

    def inputs(epoch):
        is_valid = valid_step > 0 and epoch % valid_step == 0
        if is_valid or not use_sub:
            return is_valid, full_graphs, x_full
        return is_valid, gs_train, x_train

    if forward_rows is not None and train_rows is not None:
        # training loss on the train-row subset only (classifier +
        # logits at mask-fraction size; see interp.make_forward)
        y_rows, tm_rows = labels[train_rows], train_mask[train_rows]

        def loss_fn(graphs, xc):
            lg = forward_rows(params, graphs, xc, train_rows)
            return masked_cross_entropy(lg, y_rows, tm_rows)
    else:
        def loss_fn(graphs, xc):
            return masked_cross_entropy(forward(params, graphs, xc), labels, train_mask)

    if forward_rows is not None and test_rows is not None:
        y_test, sm_test = labels[test_rows], test_mask[test_rows]

        def test_acc(p):
            return masked_accuracy(forward_rows(p, full_graphs, x_full, test_rows),
                                   y_test, sm_test)
    else:
        def test_acc(p):
            return masked_accuracy(forward(p, full_graphs, x_full), labels, test_mask)

    losses, snapshots = [], []
    mem_mb = 0.0
    timer = EpochTimer(device)

    # ---- training phase ------------------------------------------------ #
    for epoch in range(iters):
        if epoch == warmup:
            timer.start()
            if measure_memory:
                mem_mb = device_memory_mb(device)
        is_valid, graphs, xc = inputs(epoch)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(graphs, xc)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if is_valid:
            snapshots.append(_snapshot(params))
    total_time = timer.stop(n=max(iters - warmup, 1))

    # ---- inference phase: forward-only epochs, same graph schedule ----- #
    with torch.no_grad():
        for epoch in range(iters):
            if epoch == warmup:
                timer.start()
            _, graphs, xc = inputs(epoch)
            forward(params, graphs, xc)
        inference_time = timer.stop(n=max(iters - warmup, 1))

        # ---- deferred metrics (outside both timed regions) ------------- #
        losses_host = torch.stack(losses).cpu().tolist() if losses else []
        accs = torch.stack([test_acc(p) for p in snapshots]).cpu().tolist() if snapshots else []

    return TrainResult(
        inference_time=inference_time,
        total_time=total_time,
        max_accuracy=float(np.max(accs)) if accs else 0.0,
        losses=losses_host,
        accuracies=accs,
        params=params,
        memory_mb=mem_mb,
    )
