"""The hand-written sharded 2-layer GCN training step (the port of
gala_tpu.parallel.train).

Parallelism over a (data, model) mesh (parallel.mesh):

- data:  nodes range-partitioned over 'data'; each rank reduces its own
         incoming edges, remote sources arrive by all_gather or a halo
         all_to_all (parallel.ops), whose gradients return them.
- model: w1 (and b1) column-split, w2 row-split (Megatron), the two
         conjugate operators of parallel.tp around them; b2 replicated.

Each rank calls make_sharded_train_step with the same arguments and runs
the returned step; the loss is the mean over every shard's train rows
and each gradient is all-reduced over the data group after the backward.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gala_tpu_torch.models.common import full_precision_matmuls
from gala_tpu_torch.parallel.graph import ShardedGraph
from gala_tpu_torch.parallel.ops import spmd_spmm, spmd_spmm_halo
from gala_tpu_torch.parallel.tp import copy_to, reduce_from
from gala_tpu_torch.train import all_reduce_grads, make_optimizer, masked_cross_entropy
from gala_tpu_torch.weights import shard_params

# this rank's slice of each weight (parallel.tp.rank_slice): w1 and b1 by
# output columns, w2 by input rows, b2 whole
PLAN = {"layer1": "col", "layer2": "row"}


def init_gcn_params(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int) -> dict:
    """The init law of gala_tpu (w uniform in +-1/sqrt(fan_in), zero biases),
    drawn on the CPU from `gen`: numpy {w1, b1, w2, b2}."""
    def uniform(shape, lim):
        return torch.empty(shape).uniform_(-lim, lim, generator=gen).numpy()

    return {"w1": uniform((d_in, d_hidden), 1.0 / math.sqrt(d_in)),
            "b1": np.zeros(d_hidden, np.float32),
            "w2": uniform((d_hidden, d_out), 1.0 / math.sqrt(d_hidden)),
            "b2": np.zeros(d_out, np.float32)}


def make_sharded_train_step(mesh, sg: ShardedGraph, d_in: int, d_hidden: int, d_out: int,
                            lr: float = 0.01, weight_decay: float = 5e-4, halo: bool = False,
                            params=None):
    """Returns (params, opt_state, step_fn, fwd_fn) for this rank of `mesh`.

    params: numpy {w1, b1, w2, b2} at full size (every rank the same), by
    default init_gcn_params from a generator seeded 0; the rank keeps its
    slices.  opt_state is the torch Adam over them (L2 before the moments,
    gala_tpu's add_decayed_weights + adam).
        step_fn(params, opt_state, x, y, mask) -> (params, opt_state, loss)
        fwd_fn(params, x) -> this rank's logits (r, d_out)
    x, y and mask are this rank's rows (ShardedGraph.rows_of)."""
    g = sg.local(mesh.coords[0], mesh.device, mesh.data_group)
    r, model = g.rows_per_shard, mesh.model_group
    if params is None:
        params = init_gcn_params(torch.Generator().manual_seed(0), d_in, d_hidden, d_out)
    nested = {"layer1": {"w": params["w1"], "b": params["b1"]},
              "layer2": {"w": params["w2"], "b": params["b2"]}}
    params = shard_params(nested, PLAN, mesh)
    opt = make_optimizer(params, lr, weight_decay)
    deg = g.deg
    norm = torch.where(deg > 0, deg.clamp_min(1.0).rsqrt(), torch.zeros_like(deg))

    def aggregate(h):
        if halo:
            return spmd_spmm_halo(g.src_halo, g.dst_local, g.vals, h, g.send_idx, r, g.n_shards,
                                  g.halo, g.edges_local, g.group)
        return spmd_spmm(g.src, g.dst_local, g.vals, h, r, g.group)

    def local_forward(p, x):
        full_precision_matmuls()
        h = aggregate(norm * x)
        h = copy_to(h, model) @ p["layer1"]["w"] + p["layer1"]["b"]  # cols split over 'model'
        h = torch.relu(norm * h)
        h = aggregate(norm * h)
        h = reduce_from(h @ p["layer2"]["w"], model) + p["layer2"]["b"]  # partial over 'model'
        return norm * h

    def step_fn(p, opt_state, x, y, mask):
        opt_state.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(local_forward(p, x), y, mask, g.group)
        loss.backward()
        all_reduce_grads(p, g.group)
        opt_state.step()
        return p, opt_state, loss.detach()

    def fwd_fn(p, x):
        return local_forward(p, x)

    return params, opt, step_fn, fwd_fn
