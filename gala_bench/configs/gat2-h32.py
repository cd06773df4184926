"""Plain reference of gat2-h32: GALA's two-layer, one-head GAT.

Each layer: h = x W + b; vl = h Wl + bl and vr = h Wr + br (one column
each); edge c -> r scores leaky_relu(vl[c] + vr[r], 0.2); a softmax over
each destination's edges (its self loop among them) weighs the sum of
h[c].  ReLU after the first layer.  Nothing is training invariant, so
there is no prefix.
"""

LAYERS = 2
SLOPE = 0.2


def shapes(feats: int, hidden: int, classes: int) -> list:
    out = []
    for i, (d_in, d_out) in enumerate([(feats, hidden), (hidden, classes)], start=1):
        out += [(f"weight{i}", d_in, d_out), (f"attenLWeight{i}", d_out, 1),
                (f"attenRWeight{i}", d_out, 1)]
    return out


def prefix(graphs, x, ops):
    return {"x": x}


def forward(params, graphs, carry, ops):
    h = carry["x"]
    for i, g in enumerate(graphs, start=1):
        h = ops.linear(params[f"weight{i}"], h)
        vl = ops.linear(params[f"attenLWeight{i}"], h)
        vr = ops.linear(params[f"attenRWeight{i}"], h)
        h = ops.attention(g, h, vl, vr, SLOPE)
        if i < len(graphs):
            h = h.relu()
    return h
