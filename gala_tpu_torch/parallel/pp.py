"""Pipeline parallelism: the GPipe schedule over torch.distributed
point-to-point sends (the port of gala_tpu.parallel.pp).

gala_tpu runs one SPMD program over a ('pipe',) mesh: a `lax.scan` over
T = n_micro + P - 1 ticks, each tick applying the local stage and one
`ppermute` ring shift, the backward derived by jax.grad through the scan.
Here each stage is a process, a rank of one group over ranks [0, P),
that holds only its own stage's parameters, and the schedule is written
out once (`_forward`, `_backward`) for `gpipe` and the SAGE step:

- forward: at tick t stage s runs its body on microbatch t - s, whose
  input it receives from stage s - 1, and sends the result to stage
  s + 1; the last stage's results are the pipeline's emissions;
- backward (GPipe's, which jax.grad through the scan gives): microbatches
  in reverse; stage s + 1 sends the gradient of each activation it
  received back to stage s, which backpropagates its own saved graph of
  that microbatch; parameter gradients accumulate in `.grad`.

Every rank posts its sends and receives in that one order, fixed by the
schedule and never by autograd: a stage whose body ignores its input
still sends a zero gradient back, so no rank waits on a shift that never
comes.  A mismatch that remains (ranks calling different schedules)
fails at the process group's timeout (multihost.spawn's `timeout`).
Under gloo a CUDA activation crosses through a pinned host buffer at
each shift (gloo's transport reads host memory); under NCCL it is sent
from the card.  The compute stays on the rank's device either way.

gala_tpu's stacked, zero-padded off-stage parameter slices (one pytree
shape for every device), both stage bodies traced on every device, and
the ring's last -> first shift that its `where` discards exist because
one program is traced for every device; a process per stage needs none.

GNN parameters are KB-scale, so the pipeline buys compute/communication
overlap, not parameter memory.  The bubble is GPipe's
(P - 1) / (n_micro + P - 1).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from gala_tpu_torch.models import sage
from gala_tpu_torch.models.common import ParamDict, linear
from gala_tpu_torch.ops.kernels.gather import gather_rows
from gala_tpu_torch.parallel.mesh import _device
from gala_tpu_torch.parallel.multihost import initialize, world_timeout
from gala_tpu_torch.train import make_optimizer, masked_cross_entropy
from gala_tpu_torch.weights import params_from_jax, params_to_numpy

_IN_FLIGHT = 2  # sends a rank leaves outstanding before it waits on the oldest


@dataclasses.dataclass
class PipeMesh:
    """One rank's view of a ('pipe',) mesh over ranks [0, n_stages)."""

    n_stages: int
    stage: int            # this rank's stage, its global rank
    group: object         # ProcessGroup over ranks [0, n_stages)
    device: torch.device
    backend: str


def make_pipe_mesh(n_stages: int, backend: str | None = None, device=None) -> PipeMesh | None:
    """The ('pipe',) mesh over ranks [0, n_stages) of the process group.
    Joins the group first where there is none (multihost.initialize,
    `backend`); a `backend` other than the group's raises, as do more
    stages than ranks.  Every rank of the group must call it (each creates
    the pipe group); ranks outside the mesh get None.  device: by
    parallel.mesh's rules (its own card under NCCL, the shared card under
    gloo, "cpu" on request)."""
    initialize(backend=backend)
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"the process group runs {have!r}, the mesh asks for {backend!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_stages > world:
        raise ValueError(f"need {n_stages} ranks, have {world}")
    group = dist.new_group(list(range(n_stages)), timeout=world_timeout())
    if rank >= n_stages:
        return None
    return PipeMesh(n_stages=n_stages, stage=rank, group=group,
                    device=_device(have, device, rank), backend=have)


# --------------------------------------------------------------------------- #
# point to point
# --------------------------------------------------------------------------- #
def _staged(mesh: PipeMesh) -> bool:
    """gloo with CUDA tensors: shifts cross through host buffers."""
    return mesh.backend == "gloo" and mesh.device.type == "cuda"


def _send(mesh: PipeMesh, peer: int, t: torch.Tensor, pending: list) -> None:
    """Post an isend of `t` to rank `peer`; `pending` keeps the buffer and
    its work until they are waited (at most _IN_FLIGHT at a time)."""
    t = t.detach().contiguous()
    if _staged(mesh):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    pending.append((t, dist.isend(t, peer, group=mesh.group)))
    while len(pending) > _IN_FLIGHT:
        pending.pop(0)[1].wait()


def _wait(pending: list) -> None:
    while pending:
        pending.pop(0)[1].wait()


def _recv(mesh: PipeMesh, peer: int, shape, dtype) -> torch.Tensor:
    """Receive a (shape, dtype) tensor from rank `peer` onto the rank's device."""
    staged = _staged(mesh)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else mesh.device,
                      pin_memory=staged)
    dist.recv(buf, peer, group=mesh.group)
    return buf.to(mesh.device) if staged else buf


def _broadcast(mesh: PipeMesh, t: torch.Tensor) -> torch.Tensor:
    """The last stage's `t` on every rank (the others pass a buffer of its
    shape and dtype)."""
    src = mesh.n_stages - 1
    if not _staged(mesh):
        dist.broadcast(t, src, group=mesh.group)
        return t
    host = t.cpu()
    dist.broadcast(host, src, group=mesh.group)
    return host.to(mesh.device)


# --------------------------------------------------------------------------- #
# the schedule
# --------------------------------------------------------------------------- #
def _forward(mesh: PipeMesh, n_micro: int, in_shape, dtype, body, train: bool) -> list:
    """This stage's forward over the stream: body(j, h) -> out on
    microbatch j at tick j + stage, h the activation received from the
    previous stage (None on stage 0, which reads its own input; a leaf
    that requires grad when training).  Each out but the last stage's is
    sent on.  Returns [(h, out)] by microbatch."""
    s, last = mesh.stage, mesh.n_stages - 1
    saved, pending = [], []
    for j in range(n_micro):
        h = None
        if s > 0:
            h = _recv(mesh, s - 1, in_shape, dtype).requires_grad_(train)
        with torch.set_grad_enabled(train):
            out = body(j, h)
        if s < last:
            _send(mesh, s + 1, out, pending)
        saved.append((h, out))
    _wait(pending)
    return saved


def _backward(mesh: PipeMesh, saved: list, last_grad) -> None:
    """GPipe's backward over `saved` (_forward's), microbatches in reverse:
    the last stage seeds microbatch j with last_grad(j, out), every other
    stage with the gradient received from the next; each stage but the
    first sends its input's gradient back.  Frees each microbatch's graph
    as it goes."""
    s, last = mesh.stage, mesh.n_stages - 1
    pending = []
    for j in reversed(range(len(saved))):
        h, out = saved[j]
        g = last_grad(j, out) if s == last else _recv(mesh, s + 1, out.shape, out.dtype)
        if out.requires_grad:
            torch.autograd.backward(out, g)
        if s > 0:
            _send(mesh, s - 1, h.grad if h.grad is not None else torch.zeros_like(h), pending)
        saved[j] = None
    _wait(pending)


def _is_map(tree) -> bool:
    return isinstance(tree, (dict, nn.ModuleDict, nn.ParameterDict))


def _leaves(tree) -> list:
    """The tensors of a nested dict/list/ParamDict tree, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if _is_map(tree):
        return [x for k in tree.keys() for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def _rebuild(tree, it):
    """`tree`'s nesting (as dicts and lists) over the tensors of `it`."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if _is_map(tree):
        return {k: _rebuild(tree[k], it) for k in tree.keys()}
    return [_rebuild(v, it) for v in tree]


class _GPipe(torch.autograd.Function):
    """The forward schedule; its backward runs the backward schedule on
    detached copies of the stage's parameters and returns their grads."""

    @staticmethod
    def forward(ctx, mesh, stage_fn, tree, xs, w_out, train, *leaves):
        copies = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        params = _rebuild(tree, iter(copies))
        n_micro = xs.shape[0]

        def body(j, h):
            return stage_fn(params, xs[j] if h is None else h, mesh.stage)

        saved = _forward(mesh, n_micro, xs.shape[1:], xs.dtype, body, train)
        if mesh.stage == mesh.n_stages - 1:
            out = torch.stack([o.detach() for _, o in saved])[..., :w_out].contiguous()
        else:
            out = torch.empty((n_micro, *xs.shape[1:-1], w_out), dtype=xs.dtype,
                              device=mesh.device)
        ctx.mesh, ctx.saved, ctx.copies = mesh, saved, copies
        return _broadcast(mesh, out)

    @staticmethod
    def backward(ctx, grad):
        def last_grad(j, out):
            g = torch.zeros_like(out)
            g[..., : grad.shape[-1]] = grad[j]
            return g

        _backward(ctx.mesh, ctx.saved, last_grad)
        grads = [c.grad for c in ctx.copies]
        ctx.saved = ctx.copies = None
        return (None,) * 6 + tuple(grads)


def gpipe(mesh: PipeMesh, stage_fn, stage_params, xs: torch.Tensor, w_out: int) -> torch.Tensor:
    """Run a microbatch stream through the P-stage pipeline.

    stage_fn(params, h, stage) -> h': the stage body on (B, W) activations
        (narrower stages pad to W); params is this rank's stage_params as
        nested dicts and lists of tensors.
    stage_params: this rank's stage's parameters (a tensor, or a dict/list/
        ParamDict tree of them).
    xs: (n_micro, B, W) microbatch stream on the rank's device, every rank
        the same (stage 0 consumes it).
    w_out: the number of valid output columns (<= W).

    Returns the (n_micro, B, w_out) outputs in microbatch order on every
    rank (broadcast from the last stage).  When stage_params require grad
    the output is differentiable: every rank must backpropagate through
    it, in the same order of gpipe calls, and the gradient is taken from
    the last stage's copy (the output is replicated, as gala_tpu's global
    array; every rank computes the same loss of it).  xs gets no gradient."""
    leaves = _leaves(stage_params)
    train = torch.is_grad_enabled() and any(p.requires_grad for p in leaves)
    return _GPipe.apply(mesh, stage_fn, stage_params, xs, w_out, train, *leaves)


# --------------------------------------------------------------------------- #
# Concrete wiring: 2-stage minibatch SAGE (one GNN layer per stage).
# Stage 0: the feature-table gathers (the gather kernel) and layer 1; the
# packed (B, (1 + f1) * H) activation (h_t | h_n1) goes to stage 1, which
# computes layer 2 and the masked loss.
# --------------------------------------------------------------------------- #
def make_sage_pipeline(mesh: PipeMesh, xt: torch.Tensor, f1: int, hidden: int, n_classes: int,
                       lr: float = 0.01, weight_decay: float = 5e-4, seed: int = 0):
    """Build this rank's stage of pipelined 2-stage minibatch-SAGE training.

    Returns (stage_params, opt, step) with
        step(stage_params, opt, micro) -> (stage_params, opt, mean_loss)
    running one epoch's microbatches through the pipeline and one Adam
    step (gala_tpu's: L2 before the moments).  micro holds tensors on the
    rank's device: t (n_micro, B), n1 (n_micro, B, f1), n2 (n_micro, B,
    f1, f2) int32, y (n_micro, B) labels, m (n_micro, B) mask.  mean_loss
    is the mean over microbatches of each one's masked mean, on every
    rank.  xt: the (N, F) feature table on the rank's device (stage 0
    gathers from it; stage 1 reads its width and dtype).

    stage_params: models.sage.init(torch.Generator().manual_seed(seed))
    split by layer, {"l1": {"fc", "sfc"}} on stage 0 and {"l2": ...} on
    stage 1 (merge_sage_params recombines them)."""
    if mesh.n_stages != 2:
        raise ValueError("SAGE wiring is 2-stage (one GNN layer per stage)")
    s, h = mesh.stage, hidden
    w_act = (1 + f1) * h
    n_feat = int(xt.shape[1])
    base = sage.init(torch.Generator().manual_seed(seed), n_feat, [hidden], n_classes)
    layer = f"l{s + 1}"
    stage_params = ParamDict({layer: ParamDict({"fc": base["fc"][s], "sfc": base["sfc"][s]})})
    stage_params = stage_params.to(mesh.device)
    opt = make_optimizer(stage_params, lr, weight_decay)

    def stage0(p, t, n1, n2):
        b = t.shape[0]
        x_t = gather_rows(xt, t)                                              # (B, F)
        x_n1 = gather_rows(xt, n1.reshape(-1)).view(b, f1, n_feat)            # (B, f1, F)
        x_n2 = gather_rows(xt, n2.reshape(-1)).view(b, f1, n2.shape[2], n_feat)
        h_t = torch.relu(linear(p["fc"], x_n1.mean(dim=1)) + linear(p["sfc"], x_t))
        h_n1 = torch.relu(linear(p["fc"], x_n2.mean(dim=2)) + linear(p["sfc"], x_n1))
        return torch.cat([h_t[:, None], h_n1], dim=1).reshape(b, w_act)

    def stage1(p, act):
        a = act.view(act.shape[0], 1 + f1, h)
        return linear(p["fc"], a[:, 1:].mean(dim=1)) + linear(p["sfc"], a[:, 0])

    def step(stage_params, opt, micro):
        n_micro, b = micro["t"].shape
        p = stage_params[layer]

        def body(j, act):
            if s == 0:
                return stage0(p, micro["t"][j], micro["n1"][j], micro["n2"][j])
            # f32 logits: the mask and its floor max(sum m, 1) stay f32
            return masked_cross_entropy(stage1(p, act).float(), micro["y"][j].long(),
                                        micro["m"][j])

        opt.zero_grad(set_to_none=True)
        saved = _forward(mesh, n_micro, (b, w_act), xt.dtype, body, True)
        if s == 1:
            loss = torch.stack([out.detach() for _, out in saved]).sum() / n_micro
        else:
            loss = torch.empty((), dtype=torch.float32, device=mesh.device)
        _backward(mesh, saved, lambda j, out: torch.full_like(out, 1.0 / n_micro))
        opt.step()
        return stage_params, opt, _broadcast(mesh, loss)

    return stage_params, opt, step


def merge_sage_params(stage_params, mesh: PipeMesh) -> ParamDict:
    """The pipelined stage params recombined into models.sage's layout
    ({"fc": [...], "sfc": [...]}) on every rank, on its device: each
    stage's tensors gathered over the pipe group (for full-graph
    validation, models.sage.forward)."""
    trees = [None] * mesh.n_stages
    dist.all_gather_object(trees, params_to_numpy(stage_params), group=mesh.group)
    layers = {k: v for tree in trees for k, v in tree.items()}
    order = [layers[f"l{i + 1}"] for i in range(len(layers))]
    return params_from_jax({"fc": [x["fc"] for x in order], "sfc": [x["sfc"] for x in order]},
                           mesh.device)
