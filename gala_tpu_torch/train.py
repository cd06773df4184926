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
- per-epoch inputs (`epoch_inputs`, dynamic sampling's {"_ra", "_rb"}):
  every epoch's are made before the timed regions; epoch e's join the
  carry of its training step and of its inference epoch, and each
  snapshot keeps its epoch's for its test accuracy, as in gala_tpu.
  Epochs count from 0 in every call, a resumed one too (gala_tpu's rule).
- checkpoints (gala_tpu_torch.checkpoint): `resume_from` restores the
  params in place and the optimizer's state before the invariant prefix;
  `checkpoint_path` saves both, with step=iters, after the deferred
  metrics.
- spans (utils.profiling.marker, recorded only under a profiler):
  `gala.prefix` each invariant call, `gala.epoch_inputs`, `gala.step`
  each training epoch (inside it `gala.forward`, `gala.backward`,
  `gala.optimizer` and, on validation epochs, `gala.snapshot`),
  `gala.infer` each inference epoch, `gala.test_eval` the deferred
  metrics, `gala.checkpoint`; EpochTimer's boundaries are `gala.fence`.

gala_tpu's XLA devices (lax.scan epoch chunks, the anti-hoisting bump,
the compile warm-up pool, host-fetch fences) have no counterpart here:
PyTorch runs each epoch eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from gala_tpu_torch.checkpoint import restore, save_checkpoint
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.utils.profiling import marker
from gala_tpu_torch.utils.timing import EpochTimer


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, group=None) -> torch.Tensor:
    """Mean CE over mask rows (mask includes padding=False rows), in f32;
    the mask takes the logits' dtype, as in gala_tpu (at bf16 logits its
    count rounds to bf16).  With `group` (a sharded run's data group) the
    rows are this rank's and both sums are all-reduced over the group
    (gala_tpu.parallel.train's psums): the loss of every shard's rows,
    whose gradient reaches this rank's rows unscaled."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    m = mask.to(logits.dtype)
    num, den = (nll * m).sum(), m.sum()
    if group is not None:
        from gala_tpu_torch.parallel.tp import reduce_from

        num, den = reduce_from(torch.stack([num, den.detach().to(num.dtype)]), group)
    return num / den.clamp_min(1.0)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, group=None) -> torch.Tensor:
    """Accuracy over mask rows; with `group`, of every shard's rows (the
    counts all-reduced)."""
    pred = logits.argmax(dim=-1)
    m = mask.to(torch.float32)
    counts = torch.stack([((pred == labels).to(torch.float32) * m).sum(), m.sum()])
    if group is not None:
        dist.all_reduce(counts, group=group)
    return counts[0] / counts[1].clamp_min(1.0)


def all_reduce_grads(params: nn.Module, group) -> None:
    """Sum every parameter's gradient over `group` in one all_reduce: a
    replicated parameter of a sharded run takes the gradient of every
    shard's loss."""
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


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
    """Live device memory allocated by PyTorch on `device` at the call, in
    MB: gala_tpu's `bytes_in_use` (the reference's cudaMemGetInfo analog),
    read at the warm-up boundary.  Not the peak: that would carry the
    warm-up's activations and an earlier model's high-water mark.  0.0 on
    the CPU, which has no device memory to report."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.memory_allocated(device) / 1e6
    return 0.0


def snapshot_params(params: nn.Module) -> dict:
    """Detached copies of a compiled model's params: the FFNs' {w, b}
    dicts and the bare learned epsilons."""
    return {name: layer.detach().clone() if isinstance(layer, torch.Tensor)
            else {k: v.detach().clone() for k, v in layer.items()}
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
    epoch_inputs: Callable | None = None,
    checkpoint_path: str | None = None,
    resume_from: str | None = None,
    group=None,
) -> TrainResult:
    """Run the full training protocol and return timing/accuracy stats.

    forward(params, graphs, x) -> logits (n_pad, n_classes)
    invariant: optional hoisted prefix fn(graphs, x) -> carry, run once
        outside the loop (training-invariant code motion product).
    train_graphs: per-layer training subgraphs; when given, non-validation
        epochs aggregate over them instead of the full graph.
    epoch_inputs: optional fn(epoch) -> dict merged into that epoch's
        carry (a dict carry only, as gala_tpu's _with_extra).
    checkpoint_path: save the final params and optimizer state there.
    resume_from: restore params and optimizer state before training; it
        raises if the file is missing or holds other parameters.
    group: a sharded run's data process group (parallel.compiled): the
        graphs and tensors are this rank's; the loss and the accuracy
        counts are summed over the group, every gradient all-reduced
        after the backward, and each timed region opens and closes with
        a barrier after the device sync.  Every rank of the group calls
        train with the same arguments.
    `params` is updated in place and returned in the result."""
    device = full_graphs[0].device
    opt = make_optimizer(params, lr, weight_decay)
    if resume_from:
        restore(resume_from, params, opt)

    with torch.no_grad():
        x_train = x_full = x
        if invariant is not None:
            with marker("gala.prefix"):
                x_train = invariant(train_graphs if train_graphs is not None else full_graphs, x)
            x_full = x_train
            if train_graphs is not None:
                with marker("gala.prefix"):
                    x_full = invariant(full_graphs, x)
    use_sub = train_graphs is not None
    gs_train = train_graphs if use_sub else full_graphs
    # every epoch's extra inputs, made before the timed regions
    with marker("gala.epoch_inputs"):
        extras = [epoch_inputs(e) for e in range(iters)] if epoch_inputs else [{}] * iters

    def with_extra(xc, extra):
        return {**xc, **extra} if extra and isinstance(xc, dict) else xc

    def inputs(epoch):
        is_valid = valid_step > 0 and epoch % valid_step == 0
        if is_valid or not use_sub:
            return is_valid, full_graphs, with_extra(x_full, extras[epoch])
        return is_valid, gs_train, with_extra(x_train, extras[epoch])

    if forward_rows is not None and train_rows is not None:
        # training loss on the train-row subset only (classifier +
        # logits at mask-fraction size; see interp.make_forward)
        y_rows, tm_rows = labels[train_rows], train_mask[train_rows]

        def loss_fn(graphs, xc):
            lg = forward_rows(params, graphs, xc, train_rows)
            return masked_cross_entropy(lg, y_rows, tm_rows)
    else:
        def loss_fn(graphs, xc):
            return masked_cross_entropy(forward(params, graphs, xc), labels, train_mask, group)

    if forward_rows is not None and test_rows is not None:
        y_test, sm_test = labels[test_rows], test_mask[test_rows]

        def test_acc(p, extra):
            return masked_accuracy(forward_rows(p, full_graphs, with_extra(x_full, extra),
                                                test_rows), y_test, sm_test)
    else:
        def test_acc(p, extra):
            return masked_accuracy(forward(p, full_graphs, with_extra(x_full, extra)), labels,
                                   test_mask, group)

    losses, snapshots = [], []
    mem_mb = 0.0
    timer = EpochTimer(device, group)

    # ---- training phase ------------------------------------------------ #
    for epoch in range(iters):
        if epoch == warmup:
            timer.start()
            if measure_memory:
                mem_mb = device_memory_mb(device)
        with marker("gala.step"):
            is_valid, graphs, xc = inputs(epoch)
            opt.zero_grad(set_to_none=True)
            with marker("gala.forward"):
                loss = loss_fn(graphs, xc)
            with marker("gala.backward"):
                loss.backward()
                if group is not None:
                    all_reduce_grads(params, group)
            with marker("gala.optimizer"):
                opt.step()
            losses.append(loss.detach())
            if is_valid:
                with marker("gala.snapshot"):
                    snapshots.append((snapshot_params(params), extras[epoch]))
    total_time = timer.stop(n=max(iters - warmup, 1))

    # ---- inference phase: forward-only epochs, same graph schedule ----- #
    with torch.no_grad():
        for epoch in range(iters):
            if epoch == warmup:
                timer.start()
            with marker("gala.infer"):
                _, graphs, xc = inputs(epoch)
                forward(params, graphs, xc)
        inference_time = timer.stop(n=max(iters - warmup, 1))

        # ---- deferred metrics (outside both timed regions) ------------- #
        with marker("gala.test_eval"):
            losses_host = torch.stack(losses).cpu().tolist() if losses else []
            accs = (torch.stack([test_acc(p, e) for p, e in snapshots]).cpu().tolist()
                    if snapshots else [])

    if checkpoint_path:
        with marker("gala.checkpoint"):
            save_checkpoint(checkpoint_path, params, opt.state_dict(), step=iters)

    return TrainResult(
        inference_time=inference_time,
        total_time=total_time,
        max_accuracy=float(np.max(accs)) if accs else 0.0,
        losses=losses_host,
        accuracies=accs,
        params=params,
        memory_mb=mem_mb,
    )
