"""Plain reference of gcn2-h32: GALA's two-layer GCN as GALA's compiler
defines it.

The DSL (gcn2-h32.json) writes each layer as norm * A(norm * h), an FFN,
norm * (.), then the nonlinearity, with norm = deg^-1/2 of the layer-0
graph (0 on rows without edges).  GALA's middle end moves the training
invariant part, norm * A(norm * x) of the first layer, out of the loop,
and its operator reordering moves each trailing norm * (.) in front of
the FFN, which changes the result because the FFN has a bias.  The
reference follows the compiled program, not the DSL text:

    h0     = norm * A0(norm * x)              once per graph set
    h1     = relu(h0 W1 + b1)
    logits = (norm * A1(norm * h1)) W2 + b2
"""

LAYERS = 2


def shapes(feats: int, hidden: int, classes: int) -> list:
    return [("weight1", feats, hidden), ("weight2", hidden, classes)]


def _norm(g):
    deg = g.degrees()
    return deg.clamp_min(1.0).pow(-0.5) * (deg > 0)


def prefix(graphs, x, ops):
    norm = _norm(graphs[0])
    return {"norm": norm, "h0": norm * ops.aggregate(graphs[0], norm * x)}


def forward(params, graphs, carry, ops):
    norm = carry["norm"]
    h1 = ops.linear(params["weight1"], carry["h0"]).relu()
    return ops.linear(params["weight2"], norm * ops.aggregate(graphs[1], norm * h1))
