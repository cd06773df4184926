"""GCN: symmetric-normalized sum aggregation, the hand-written oracle of
the compiled GCN (the port of gala_tpu.models.gcn).

    norm = deg^-0.5          (invariant, detached)
    res  = norm * x          (row broadcast)
    res  = A @ res           (SpMM)
    res  = res @ W + b       (FFN)
    res  = norm * res
    x    = relu(res)         (skipped on the last layer)
"""
from __future__ import annotations

import torch
from torch import nn

from gala_tpu_torch.models.common import gcn_norm, layer_sizes, linear, linear_init
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.spmm import spmm


def init(gen: torch.Generator, n_feats: int, hidden: list[int], n_classes: int):
    sizes = layer_sizes(n_feats, hidden, n_classes)
    return nn.ModuleDict({"fc": nn.ModuleList([linear_init(gen, i, o) for i, o in sizes])})


def forward(params, graphs: list[Graph], x: torch.Tensor) -> torch.Tensor:
    n_layers = len(params["fc"])
    for li in range(n_layers):
        g = graphs[li]
        norm = gcn_norm(g)
        res = spmm(g, norm * x)
        res = norm * linear(params["fc"][li], res)
        x = torch.relu(res) if li < n_layers - 1 else res
    return x
