"""The plain reference: full-graph training of a compiled GALA program's
model in plain PyTorch, float32 with TF32 off, on the benchmark's own CSR.

It imports nothing of the port and takes nothing that the port made: it
builds the training subgraphs, the degrees and the invariant prefix again
from the graph, and runs its own Adam.  Each configuration's model lives
beside its file (configs/<name>.py) and is written against `Ops`, which
holds the sparse aggregations and the dense product, so the control can
run the same model with the product in TF32 (`Ops(tf32=True)`).

The training protocol is the program's (gala_tpu_torch.train, GALA's
generated loop): Adam with L2 weight decay added to the gradient,
cross-entropy averaged over the train rows, and every `valid_step`-th
epoch (epoch 0 among them) on the full graph, the others on the per-layer
training subgraphs.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


# ---------------------------------------------------------------------- #
# graphs
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class RefGraph:
    """A CSR by destination plus its transpose, for aggregation both ways."""

    n: int
    crow: torch.Tensor
    col: torch.Tensor
    row: torch.Tensor
    t_crow: torch.Tensor
    t_col: torch.Tensor
    t_perm: torch.Tensor   # transpose position -> forward edge id

    @classmethod
    def from_edges(cls, row: torch.Tensor, col: torch.Tensor, n: int) -> "RefGraph":
        """From edges sorted by (row, col)."""
        crow = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
        crow[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
        t_perm = torch.argsort(col * n + row)
        t_crow = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
        t_crow[1:] = torch.cumsum(torch.bincount(col, minlength=n), 0)
        return cls(n=n, crow=crow, col=col, row=row, t_crow=t_crow, t_col=row[t_perm],
                   t_perm=t_perm)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def degrees(self) -> torch.Tensor:
        """(n, 1) in-degrees."""
        return (self.crow[1:] - self.crow[:-1]).to(torch.float32)[:, None]

    def keep_rows(self, rows: torch.Tensor) -> "RefGraph":
        """The edges whose destination is in the bool mask `rows`."""
        keep = rows[self.row]
        return RefGraph.from_edges(self.row[keep], self.col[keep], self.n)


def layer_rows(row: torch.Tensor, col: torch.Tensor, train: torch.Tensor,
               n_layers: int) -> list[torch.Tensor]:
    """Layer i's destination rows: the nodes within (n_layers - 1 - i)
    hops of the train rows, which a training loss reads (GALA's
    getMaskSubgraphs)."""
    masks = [train]
    for _ in range(n_layers - 1):
        grown = masks[-1].clone()
        grown[col[masks[-1][row]]] = True
        masks.append(grown)
    return [masks[n_layers - 1 - i] for i in range(n_layers)]


def training_subgraphs(g: RefGraph, train: torch.Tensor, n_layers: int) -> list[RefGraph]:
    """Layer i keeps the edges into its destination rows (layer_rows)."""
    return [g.keep_rows(m) for m in layer_rows(g.row, g.col, train, n_layers)]


def _csr_mm(crow, col, vals, x, n):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta" and invariant-check notes
        a = torch.sparse_csr_tensor(crow, col, vals, size=(n, x.shape[0]))
    return torch.sparse.mm(a, x) if x.is_cuda else a.matmul(x)


class _Aggregate(torch.autograd.Function):
    """out[r] = sum over edges c -> r of w[e] * h[c]; gradients to h and,
    when w needs one, to w (dot of dout[r] and h[c], in blocks)."""

    @staticmethod
    def forward(ctx, g: RefGraph, w: torch.Tensor, h: torch.Tensor):
        ctx.g = g
        ctx.save_for_backward(w, h)
        return _csr_mm(g.crow, g.col, w, h.contiguous(), g.n)

    @staticmethod
    def backward(ctx, dout):
        g = ctx.g
        w, h = ctx.saved_tensors
        dout = dout.contiguous()
        dh = _csr_mm(g.t_crow, g.t_col, w[g.t_perm], dout, g.n) if ctx.needs_input_grad[2] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.empty_like(w)
            block = max(1, (1 << 26) // max(h.shape[1], 1))
            for lo in range(0, g.nnz, block):
                hi = min(lo + block, g.nnz)
                dw[lo:hi] = (dout[g.row[lo:hi]] * h[g.col[lo:hi]]).sum(1)
        return None, dw, dh


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + (0xFFF + ((bits >> 13) & 1))
    return (bits & ~0x1FFF).view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    """a @ b with both operands of each product rounded to TF32: what
    cuBLAS computes with TF32 on, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, d):
        a, b = ctx.saved_tensors
        rd = round_tf32(d)
        return rd @ round_tf32(b).T, round_tf32(a).T @ rd


class Ops:
    """The operations the models are written in.  float32 with TF32 off,
    or, for the control, every dense product in TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Tf32Mm.apply(a, b) if self.tf32 else a @ b

    def linear(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, p["w"]) + p["b"]

    @staticmethod
    def aggregate(g: RefGraph, h: torch.Tensor) -> torch.Tensor:
        """Sum of each destination's neighbours' rows."""
        ones = torch.ones(g.nnz, dtype=h.dtype, device=h.device)
        return _Aggregate.apply(g, ones, h)

    @staticmethod
    def attention(g: RefGraph, h: torch.Tensor, vl: torch.Tensor, vr: torch.Tensor,
                  slope: float) -> torch.Tensor:
        """GAT's aggregation: edge c -> r scores leaky_relu(vl[c] + vr[r]),
        a softmax over each destination's edges, the weighted sum of h[c]."""
        z = F.leaky_relu(vl[g.col, 0] + vr[g.row, 0], slope)
        zmax = torch.full((g.n,), float("-inf"), device=z.device).scatter_reduce(
            0, g.row, z.detach(), "amax")
        ez = torch.exp(z - zmax[g.row])
        den = torch.zeros(g.n, device=z.device, dtype=z.dtype).index_add(0, g.row, ez)
        return _Aggregate.apply(g, ez / den[g.row], h)


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #
def init_weights(shapes: list[tuple[str, int, int]], seed: int, device) -> dict:
    """{name: {"w": (d_in, d_out), "b": (d_out,)}} under nn.Linear's law,
    U(-1/sqrt(d_in), 1/sqrt(d_in)), drawn in one call from `seed` on
    `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(i * o + o for _, i, o in shapes)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, i, o in shapes:
        bound = 1.0 / max(i, 1) ** 0.5
        w = u[off : off + i * o].view(i, o) * bound
        b = u[off + i * o : off + i * o + o] * bound
        out[name] = {"w": w.clone(), "b": b.clone()}
        off += i * o + o
    return out


def leaves(params: dict) -> dict:
    return {f"{name}.{k}": t for name, p in params.items() for k, t in p.items()}


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits[rows].float(), labels[rows])


class Adam:
    """torch's Adam with L2 weight decay (added to the gradient before the
    moments), written out so the reference shares no optimizer with the
    program."""

    def __init__(self, params: list, lr: float, weight_decay: float):
        self.params, self.lr, self.wd, self.t = params, lr, weight_decay, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = BETAS
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.wd * p
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** self.t)).sqrt_().add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))


@dataclasses.dataclass
class Readings:
    """The first steps of one job: each step's loss, each leaf's gradient
    as Adam took it in step 1 (from its first moment), and each leaf's
    parameters after the last step."""

    losses: list
    grads: dict
    params: dict
    raw_grads: dict     # step 1's gradients before weight decay


def follow(model, graph: RefGraph, feats: torch.Tensor, labels: torch.Tensor,
           train: torch.Tensor, weights: dict, loop: dict, steps: int = 3,
           ops: Ops | None = None, loss_rows: torch.Tensor | None = None,
           subs: list | None = None) -> Readings:
    """Train `model` (a configuration's reference module) from `weights`
    for `steps` epochs of the program's protocol and read them.
    `loss_rows` (the train rows by default) are the rows the loss
    averages over; `subs`, the training subgraphs if already built."""
    ops = ops or Ops()
    n_layers = model.LAYERS
    subs = subs or training_subgraphs(graph, train, n_layers)
    full = [graph] * n_layers
    rows = torch.nonzero(train).flatten() if loss_rows is None else loss_rows
    params = {name: {k: t.detach().clone().requires_grad_(True) for k, t in p.items()}
              for name, p in weights.items()}
    flat = list(leaves(params).values())
    opt = Adam(flat, float(loop["lr"]), float(loop["weight_decay"]))
    carries = {}
    losses, grads, raw = [], {}, {}
    for epoch in range(steps):
        valid = epoch % int(loop["valid_step"]) == 0
        graphs = full if valid else subs
        key = "full" if valid else "train"
        if key not in carries:
            with torch.no_grad():
                carries[key] = model.prefix(graphs, feats, ops)
        for p in flat:
            p.grad = None
        loss = masked_ce(model.forward(params, graphs, carries[key], ops), labels, rows)
        loss.backward()
        if epoch == 0:
            raw = {name: p.grad.clone() for name, p in leaves(params).items()}
        opt.step()
        losses.append(float(loss.detach()))
        if epoch == 0:
            grads = {name: m / (1 - BETAS[0]) for name, m in zip(leaves(params), opt.m)}
    return Readings(losses=losses, grads=grads,
                    params={k: t.detach().clone() for k, t in leaves(params).items()},
                    raw_grads=raw)
