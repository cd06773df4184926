"""GIN: sum aggregation with a learned epsilon self-weighting, the
hand-written oracle of the compiled GIN (the port of gala_tpu.models.gin).

    res_n = A @ x                      (SpMM)
    res   = (1 + eps) * x              (eps a learned f32 scalar, init 0;
                                        f32 at bf16 x, as in gala_tpu)
    res   = res + res_n
    res   = res @ W + b                (FFN)
    x     = relu(res)                  (skipped on the last layer)

Parameters keep gala_tpu's layout: {"fc": [{w, b}], "eps": [0-d, ...]}.
"""
from __future__ import annotations

import torch
from torch import nn

from gala_tpu_torch.models.common import (
    ParamDict, epsilon_param, layer_sizes, linear, linear_init, scale_by_eps,
)
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.spmm import spmm


def init(gen: torch.Generator, n_feats: int, hidden: list[int], n_classes: int) -> ParamDict:
    sizes = layer_sizes(n_feats, hidden, n_classes)
    return ParamDict({
        "fc": nn.ModuleList([linear_init(gen, i, o) for i, o in sizes]),
        "eps": nn.ParameterList([epsilon_param() for _ in sizes]),
    })


def forward(params, graphs: list[Graph], x: torch.Tensor) -> torch.Tensor:
    n_layers = len(params["fc"])
    for li in range(n_layers):
        g = graphs[li]
        res = scale_by_eps(params["eps"][li], x) + spmm(g, x)
        res = linear(params["fc"][li], res)
        x = torch.relu(res) if li < n_layers - 1 else res
    return x
