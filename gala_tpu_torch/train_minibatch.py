"""Minibatch GraphSAGE training, the neighbor-sampled gather pipeline (the
port of gala_tpu.train_minibatch).

The BASELINE "GraphSAGE with neighbor sampling on Reddit" config:

- host: `NeighborSampler` (gala_tpu_torch.data.minibatch, shared with
  gala_tpu) produces an EPOCH of fixed-shape index tensors at once;
  they are copied to the device once per epoch;
- device: each batch is three row gathers from the device-resident
  feature table, run by the hand-written gather kernel
  (ops.kernels.gather), then means and dense matmuls (the mean-aggregate
  SAGE estimator); one Adam step per batch, eagerly (gala_tpu's one
  lax.scan per epoch has no counterpart: PyTorch runs each batch as it
  comes, so the epoch is bound by launch overhead);
- parameters are SHARED with the full-graph SAGE model
  (gala_tpu_torch.models.sage): validation runs the full-graph forward
  with the same weights.

Timing, as gala_tpu's: the device work of each epoch (not sampling, not
the index copy), bracketed by one synchronize at each end; batch losses
accumulate on the device and are read after the closing synchronize.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gala_tpu_torch.data.csr import HostCSR
from gala_tpu_torch.data.minibatch import NeighborSampler
from gala_tpu_torch.models import sage
from gala_tpu_torch.models.common import activation_dtype, linear
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.kernels.gather import gather_rows
from gala_tpu_torch.train import (
    TrainResult, make_optimizer, masked_accuracy, masked_cross_entropy,
)
from gala_tpu_torch.utils.timing import fence


def forward_minibatch(params, xt: torch.Tensor, t: torch.Tensor, n1: torch.Tensor,
                      n2: torch.Tensor) -> torch.Tensor:
    """2-layer mean-aggregate SAGE on a sampled neighborhood.

    xt: (N_pad, F) device feature table; t: (B,), n1: (B, f1), n2: (B,
    f1, f2) sampled int32 indices.  Returns (B, C) logits.  Weight
    layout as gala_tpu_torch.models.sage (fc = neighbor FFN, sfc = self
    FFN; relu between layers, none on the last)."""
    b, f1 = n1.shape
    f = xt.shape[1]
    x_t = gather_rows(xt, t)                                          # (B, F)
    x_n1 = gather_rows(xt, n1.reshape(-1)).view(b, f1, f)             # (B, f1, F)
    x_n2 = gather_rows(xt, n2.reshape(-1)).view(b, f1, n2.shape[2], f)  # (B, f1, f2, F)
    fc, sfc = params["fc"], params["sfc"]
    h_t = torch.relu(linear(fc[0], x_n1.mean(dim=1)) + linear(sfc[0], x_t))      # (B, H)
    h_n1 = torch.relu(linear(fc[0], x_n2.mean(dim=2)) + linear(sfc[0], x_n1))    # (B, f1, H)
    return linear(fc[1], h_n1.mean(dim=1)) + linear(sfc[1], h_t)


def train_sage_minibatch(
    g_host: HostCSR,
    feats: np.ndarray,
    labels: np.ndarray,
    masks: dict,
    fanouts: tuple[int, int] = (25, 10),
    batch_size: int = 512,
    hidden: int = 32,
    iters: int = 10,
    valid_step: int = 2,
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    warmup: int = 1,
    seed: int = 0,
    dtype=None,
    dynamic: bool = True,
    device="cuda",
) -> TrainResult:
    """Train minibatch SAGE on `device`; validate full-graph with the same
    params.  Epoch times are the mean over the epochs after `warmup`.
    dtype=torch.bfloat16 casts the feature table (gala_tpu's mixed
    precision: params and the batch loss stay f32)."""
    dtype = activation_dtype(dtype)
    device = torch.device(device)
    n_classes = int(labels.max()) + 1
    g = Graph.from_host(g_host, device=device)  # full graph for validation only
    xt = g.pad_nodes(np.asarray(feats, np.float32))
    if dtype is not None:
        xt = xt.to(dtype)
    y_pad = g.pad_nodes(np.asarray(labels, np.int64))
    test_mask = g.pad_nodes(np.asarray(masks["test"], bool))

    params = sage.init(torch.Generator().manual_seed(seed), feats.shape[1], [hidden],
                       n_classes).to(device)
    opt = make_optimizer(params, lr, weight_decay)

    sampler = NeighborSampler(g_host, fanouts, batch_size)
    train_nodes = np.flatnonzero(np.asarray(masks["train"]))
    y_np = np.asarray(labels, np.int64)

    def full_accuracy() -> float:
        with torch.no_grad():
            return float(masked_accuracy(sage.forward(params, [g, g], xt), y_pad, test_mask))

    losses, accs, epoch_times = [], [], []
    for ep in range(iters):
        eb = sampler.epoch(train_nodes, ep, seed=seed, dynamic=dynamic)
        t, n1, n2, yb, mb = (torch.from_numpy(a).to(device) for a in
                             (eb.targets, eb.n1, eb.n2, y_np[eb.targets], eb.mask))
        fence(device)
        t0 = time.perf_counter()
        total = torch.zeros((), dtype=torch.float32, device=device)
        for b in range(t.shape[0]):
            opt.zero_grad(set_to_none=True)
            # f32 logits: the batch loss's mask stays f32, as gala_tpu's
            loss = masked_cross_entropy(
                forward_minibatch(params, xt, t[b], n1[b], n2[b]).float(), yb[b], mb[b])
            loss.backward()
            opt.step()
            total += loss.detach()
        fence(device)
        if ep >= warmup:
            epoch_times.append(time.perf_counter() - t0)
        losses.append(float(total) / t.shape[0])
        if valid_step and ep % valid_step == 0:
            accs.append(full_accuracy())
    if valid_step:
        accs.append(full_accuracy())
    mean_epoch = float(np.mean(epoch_times)) if epoch_times else 0.0
    return TrainResult(
        params=params,
        losses=losses,
        accuracies=accs,
        inference_time=mean_epoch,
        total_time=mean_epoch,
        max_accuracy=max(accs) if accs else 0.0,
        memory_mb=0.0,
    )
