"""GAT: additive attention with edge softmax, single- or multi-head, the
hand-written oracle of the compiled GAT (the port of gala_tpu.models.gat).

    res   = x @ W + b                        (FFN)
    attnL = per-head <res_h, aL_h> + bL_h    (H scores per node)
    attnR = per-head <res_h, aR_h> + bR_h
    res   = attention_aggregate(res, attnL, attnR)   (fused: SDDVV-add,
            leaky-relu, edge softmax and SpMM with the softmax values)
    x     = relu(res)                        (skipped on the last layer)

A graph without the fused layout (any strategy but 'bell' with
attention=True) runs the same chain unfused, head by head: SDDVV-add,
leaky ReLU, edge softmax and spmm_ev (ops.edge, ops.spmm).

Multi-head: each head h owns attention vectors of size fh; hidden layers
concatenate heads, the final layer averages them.  Parameters keep
gala_tpu's layout: {"fc": [{w, b}], "attn_l": [{w (H, fh), b (H,)}],
"attn_r": [...]}, one entry per layer.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from gala_tpu_torch.models.common import layer_sizes, linear, linear_init
from gala_tpu_torch.ops.attention import attention_aggregate
from gala_tpu_torch.ops.edge import edge_softmax, leaky_relu, sddvv_add
from gala_tpu_torch.ops.graph import Graph
from gala_tpu_torch.ops.spmm import spmm_ev


def _attn_vec_init(gen: torch.Generator, n_heads: int, fh: int) -> nn.ParameterDict:
    """Per-head attention vectors, U(-1/sqrt(fh)) as nn.Linear(fh, 1) per head."""
    bound = 1.0 / math.sqrt(max(fh, 1))
    w = torch.empty((n_heads, fh)).uniform_(-bound, bound, generator=gen)
    b = torch.empty((n_heads,)).uniform_(-bound, bound, generator=gen)
    return nn.ParameterDict({"w": nn.Parameter(w), "b": nn.Parameter(b)})


def _head_scores(p, res: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(N, H): score[n, h] = res[n, h*fh:(h+1)*fh] @ w[h] + b[h]."""
    r3 = res.view(res.shape[0], n_heads, -1)
    return torch.einsum("nhf,hf->nh", r3, p["w"]) + p["b"]


def init(gen: torch.Generator, n_feats: int, hidden: list[int], n_classes: int,
         n_heads: int = 1) -> nn.ModuleDict:
    sizes = layer_sizes(n_feats, [h * n_heads for h in hidden], n_classes)
    per_head = [*hidden, n_classes]
    return nn.ModuleDict({
        "fc": nn.ModuleList([linear_init(gen, i, n_heads * o)
                             for (i, _), o in zip(sizes, per_head)]),
        "attn_l": nn.ModuleList([_attn_vec_init(gen, n_heads, o) for o in per_head]),
        "attn_r": nn.ModuleList([_attn_vec_init(gen, n_heads, o) for o in per_head]),
    })


def forward(params, graphs: list[Graph], x: torch.Tensor, negative_slope: float = 0.2,
            n_heads: int = 1) -> torch.Tensor:
    n_layers = len(params["fc"])
    for li in range(n_layers):
        g = graphs[li]
        res = linear(params["fc"][li], x)                          # (N, H*fh)
        fh = res.shape[1] // n_heads
        attn_l = _head_scores(params["attn_l"][li], res, n_heads)  # (N, H)
        attn_r = _head_scores(params["attn_r"][li], res, n_heads)
        if g.attn is not None:
            res = attention_aggregate(g.n_pad, g.c_pad, negative_slope, g.attn,
                                      res, attn_l, attn_r)
        else:
            h_outs = []
            for h in range(n_heads):
                logits = sddvv_add(g, attn_l[:, h : h + 1], attn_r[:, h : h + 1])
                vals = edge_softmax(g, leaky_relu(logits, negative_slope))
                h_outs.append(spmm_ev(g, vals, res[:, h * fh : (h + 1) * fh]))
            res = torch.cat(h_outs, dim=1) if n_heads > 1 else h_outs[0]
        if li == n_layers - 1 and n_heads > 1:
            res = res.view(res.shape[0], n_heads, fh).mean(dim=1)
        x = torch.relu(res) if li < n_layers - 1 else res
    return x
