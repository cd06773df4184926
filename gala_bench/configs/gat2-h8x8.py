"""Plain reference of gat2-h8x8: the GAT paper's two-layer multi-head
model (8 heads of 8, ELU, 8 averaged output heads), with GALA's biases.

Each layer: z = h W + b, viewed as H heads of F' columns; head k scores
vl_k = z_k a_L,k + b_L,k and vr_k = z_k a_R,k + b_R,k from its own
columns z_k; edge c -> r scores leaky_relu(vl_k[c] + vr_k[r], 0.2); a
softmax over each destination's edges (its self loop among them), head by
head, weighs the sum of z_k[c].  The hidden layer concatenates its heads
and applies ELU; the output layer averages its heads.  Nothing is
training invariant, so there is no prefix.

Parameters in the program's names: weight{i} (d_in, H F'),
attenLWeight{i} and attenRWeight{i} (F', H) with a bias of H.
"""
import torch
import torch.nn.functional as F

LAYERS = 2
SLOPE = 0.2
HEADS = 8        # hidden layer, each `hidden` wide
OUT_HEADS = 8    # output layer, each `classes` wide, averaged


def shapes(feats: int, hidden: int, classes: int) -> list:
    out = []
    layers = [(feats, hidden, HEADS), (HEADS * hidden, classes, OUT_HEADS)]
    for i, (d_in, fh, nh) in enumerate(layers, start=1):
        out += [(f"weight{i}", d_in, nh * fh), (f"attenLWeight{i}", fh, nh),
                (f"attenRWeight{i}", fh, nh)]
    return out


def prefix(graphs, x, ops):
    return {"x": x}


def _score(p, z_k, k, ops):
    """Head k's (N, 1) score from its own columns z_k."""
    return ops.mm(z_k, p["w"][:, k : k + 1]) + p["b"][k]


def forward(params, graphs, carry, ops):
    h = carry["x"]
    for i, g in enumerate(graphs, start=1):
        nh = HEADS if i < len(graphs) else OUT_HEADS
        z = ops.linear(params[f"weight{i}"], h)
        fh = z.shape[1] // nh
        outs = []
        for k in range(nh):
            z_k = z[:, k * fh : (k + 1) * fh]
            vl = _score(params[f"attenLWeight{i}"], z_k, k, ops)
            vr = _score(params[f"attenRWeight{i}"], z_k, k, ops)
            outs.append(ops.attention(g, z_k, vl, vr, SLOPE))
        if i < len(graphs):
            h = F.elu(torch.cat(outs, dim=1))
        else:
            h = torch.stack(outs).mean(dim=0)
    return h
