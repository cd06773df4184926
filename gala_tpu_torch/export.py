"""Export: a CompiledModel written to a standalone artifact and replayed
without the compiler (the port of gala_tpu.export).

The reference's codegen writes a standalone `./gala_model` executable
that is re-run without the compiler; gala_tpu serializes its jitted
steps with `jax.export`.  Here the forward (params, features) ->
logits is exported with `torch.export` and saved with
`torch.export.save`: the graph layouts are constants of the exported
program, and the sparse ops appear in it as the custom ops of
ops.kernels.library, whose registered gradients let the loaded program
back-propagate.  The loader needs no parser, IR, passes or lowering; it
does need gala_tpu_torch.ops.kernels, because the hand kernels are not
inside the `.pt2` (as Mosaic calls sit inside gala_tpu's StableHLO): the
program names the ops, and importing ops.kernels.library registers them.

Artifact layout (a directory):

    manifest.json       protocol metadata: iters, valid_step, chunk
                        length, warmup, csv flags, platforms, dtypes,
                        dataset, lr, weight_decay, format version
    fwd.<platform>.pt2  the exported forward, one per platform
    state.pt            params, Adam's state, the bound features (the
                        hoisted prefix's product), labels and masks,
                        CPU tensors written with torch.save

A training step cannot be serialized through torch's public API, so
`ExportedModel.train` replays gala_tpu's protocol around the loaded
forward: the masked cross-entropy, backward through the ops' registered
gradients, and `train.make_optimizer`'s Adam(lr, weight_decay).  The
plan is gala_tpu's (`_chunk_plan`: warm-up epochs out of the timings,
a validation snapshot every `valid_step` epochs, the runs between them
in chunks of `chunk` epochs); a chunk, a `lax.scan` that amortises TPU
dispatch there, is that many steps back to back here, and a forward
chunk that many forwards.  Test accuracy is evaluated on the snapshots
after the timed regions.

v1 scope, gala_tpu's: full-graph epochs (no per-layer training subgraphs)
and no per-epoch inputs, so dynamic sampling refuses export.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch import nn

from gala_tpu_torch.models.common import ParamDict, full_precision_matmuls
from gala_tpu_torch.ops.graph import moved
from gala_tpu_torch.ops.kernels import library  # noqa: F401  (registers the ops)
from gala_tpu_torch.train import (
    TrainResult, device_memory_mb, make_optimizer, masked_accuracy, masked_cross_entropy,
    snapshot_params,
)
from gala_tpu_torch.utils.timing import EpochTimer

FORMAT_VERSION = 2  # 2: the layouts carry the work units' warp tables
WARMUP = 5


class _Forward(nn.Module):
    """forward(params, feats) -> logits over fixed graphs: what is
    exported.  `feats` are the carry's tensors in the order of `uids`."""

    def __init__(self, forward, graphs, uids):
        super().__init__()
        self._fn, self._graphs, self._uids = forward, graphs, uids

    def forward(self, params: dict, feats: list):
        return self._fn(params, self._graphs, dict(zip(self._uids, feats)))


def _tree(params, order=None) -> dict:
    """A ParamDict as the exported forward takes it: {name: {"w", "b"}} and
    GIN's bare epsilons, the parameters themselves, with the names in the
    order of `order` (a ParamDict; default: params' own), as the exported
    program's inputs are matched by position."""
    order = params if order is None else order
    return {name: params[name] if isinstance(p, torch.Tensor)
            else {k: params[name][k] for k in p.keys()} for name, p in order.items()}


def _param_dict(tree: dict) -> ParamDict:
    """A _tree of tensors as trainable parameters."""
    params = ParamDict()
    for name, p in tree.items():
        params[name] = (nn.Parameter(p) if isinstance(p, torch.Tensor)
                        else nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()}))
    return params


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict) else v.detach().to(device)
            for k, v in tree.items()}


def _dtypes(tree) -> dict:
    return {k: _dtypes(v) if isinstance(v, dict) else str(v.dtype).removeprefix("torch.")
            for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# export
# --------------------------------------------------------------------------- #
def export_compiled(cm, path: str, platforms: tuple[str, ...] | None = None, seed: int = 0,
                    chunk: int | None = None) -> str:
    """Write `cm` (a CompiledModel) with fresh make_params(seed) weights
    into the directory `path` and return it.

    platforms: devices the forward is exported for (default: the model's,
    ("cuda",) on the card); for one the model is not on, the layouts are
    moved there (ops.graph.moved).
    chunk: run length of the replay's chunks (default: valid_step - 1,
    the run between validation epochs)."""
    if cm.spec.compute.sample_dynamic:
        # per-epoch (_ra, _rb) sampling inputs cannot ride a serialized
        # artifact: the exported forward would freeze one neighborhood
        # (interp's constant fallback), a different model
        raise NotImplementedError(
            "export of dynamic-sampling programs is not supported: the "
            "artifact would train on one frozen neighborhood every epoch")
    loop = cm.program.loop
    valid_step = loop.valid_step or 5
    if chunk is None:
        chunk = max(valid_step - 1, 1)
    platforms = tuple(platforms or (cm.device.type,))

    params = cm.make_params(seed)
    opt = make_optimizer(params, loop.lr, loop.weight_decay)
    # the hoisted training-invariant prefix runs once here; its product is
    # the artifact's bound features (the loader never runs it)
    with torch.no_grad():
        carry = cm.invariant(cm.full_graphs, cm.x)
    uids = list(carry)
    feats = [carry[u] for u in uids]

    os.makedirs(path, exist_ok=True)
    for platform in platforms:
        device = torch.device(platform)
        if device.type == cm.device.type:
            graphs, xs = cm.full_graphs, feats
        else:
            graphs, xs = moved(cm.full_graphs, device), [f.to(device) for f in feats]
        # the params require grad while tracing, so the forward records
        # the gradient's inputs (the fused attention's flash statistics)
        p = {k: ({n: t.requires_grad_() for n, t in v.items()} if isinstance(v, dict)
                 else v.requires_grad_()) for k, v in _on(_tree(params), device).items()}
        ep = torch.export.export(_Forward(cm.forward, graphs, uids), (p, xs), strict=False)
        ep.example_inputs = None  # the features are state.pt's; not a second copy
        torch.export.save(ep, os.path.join(path, f"fwd.{device.type}.pt2"))

    tree = _on(_tree(params), "cpu")
    state = {
        "params": tree,
        "opt_state": opt.state_dict(),
        "feats": [f.cpu() for f in feats],
        "labels": cm.labels.cpu(),
        "train_mask": cm.train_mask.cpu(),
        "test_mask": cm.test_mask.cpu(),
    }
    torch.save(state, os.path.join(path, "state.pt"))
    manifest = {
        "version": FORMAT_VERSION,
        "iters": loop.iters,
        "valid_step": valid_step,
        "chunk": chunk,
        "warmup": WARMUP,
        "print_accuracy": bool(cm.spec.print_accuracy),
        "print_memory": bool(cm.spec.print_memory),
        "platforms": [torch.device(p).type for p in platforms],
        "dtypes": {"params": _dtypes(tree),
                   "feats": [str(f.dtype).removeprefix("torch.") for f in feats]},
        "dataset": cm.spec.dataset,
        "lr": loop.lr,
        "weight_decay": loop.weight_decay,
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


# --------------------------------------------------------------------------- #
# load + replay
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ExportedModel:
    """A loaded artifact: replays the reference training protocol through
    the exported forward alone."""

    path: str
    manifest: dict
    module: nn.Module        # the loaded program: (params tree, feats) -> logits
    params: ParamDict        # trained in place by train()
    opt: torch.optim.Optimizer
    feats: list
    labels: torch.Tensor
    train_mask: torch.Tensor
    test_mask: torch.Tensor
    device: torch.device

    def forward(self, params: ParamDict | None = None) -> torch.Tensor:
        """Logits (n_pad, classes) of the current params (or of `params`,
        with the same names and shapes), computed with gradients on."""
        full_precision_matmuls()
        return self.module(_tree(self.params if params is None else params, self.params),
                           self.feats)

    def _step(self) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = masked_cross_entropy(self.forward(), self.labels, self.train_mask)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def train(self, iters: int | None = None) -> TrainResult:
        """Replay `iters` epochs (the manifest's by default) from the
        current params and optimizer state, which it updates."""
        full_precision_matmuls()
        m = self.manifest
        iters = iters if iters is not None else m["iters"]
        valid_step, warmup, k = m["valid_step"], m["warmup"], m["chunk"]
        plan = _chunk_plan(iters, valid_step, warmup, k)
        losses, snapshots = [], []
        mem_mb = 0.0
        timer = EpochTimer(self.device)
        for kind, epoch, length in plan:
            if epoch == warmup:
                timer.start()
                if m["print_memory"]:
                    mem_mb = device_memory_mb(self.device)
            losses += [self._step() for _ in range(length)]
            if kind == "single" and valid_step > 0 and epoch % valid_step == 0:
                snapshots.append(snapshot_params(self.params))
        total_time = timer.stop(n=max(iters - warmup, 1))

        with torch.no_grad():
            tree = _tree(self.params)
            for kind, epoch, length in plan:
                if epoch == warmup:
                    timer.start()
                for _ in range(length):
                    self.module(tree, self.feats)
            inference_time = timer.stop(n=max(iters - warmup, 1))
            accs = (torch.stack([masked_accuracy(self.module(p, self.feats), self.labels,
                                                 self.test_mask) for p in snapshots])
                    .cpu().tolist() if snapshots else [])
        return TrainResult(
            inference_time=inference_time,
            total_time=total_time,
            max_accuracy=max(accs) if accs else 0.0,
            losses=torch.stack(losses).cpu().tolist() if losses else [],
            accuracies=accs,
            params=self.params,
            memory_mb=mem_mb,
        )

    def run(self, iters: int | None = None) -> str:
        res = self.train(iters=iters)
        return res.csv(self.manifest["print_accuracy"], self.manifest["print_memory"])


def _chunk_plan(iters: int, valid_step: int, warmup: int, K: int):
    """('single', e, 1) / ('chunk', e, K) items; chunks never cross a
    validation epoch or the warmup boundary, ragged tails fall back to
    singles (gala_tpu's plan, whose exported chunks have a fixed length)."""
    plan, e = [], 0
    while e < iters:
        if valid_step > 0 and e % valid_step == 0:
            plan.append(("single", e, 1))
            e += 1
            continue
        nxt = ((e // valid_step) + 1) * valid_step if valid_step > 0 else iters
        end = min(iters, nxt, warmup if e < warmup else iters)
        while end - e >= K and K > 1:
            plan.append(("chunk", e, K))
            e += K
        while e < end:
            plan.append(("single", e, 1))
            e += 1
    return plan


def _has(platform: str) -> bool:
    return platform == "cpu" or (platform == "cuda" and torch.cuda.is_available())


def load_exported(path: str, device=None) -> ExportedModel:
    """Load the artifact at `path` onto `device` (default: the first of its
    platforms this machine has).  Raises, naming the platforms, when the
    machine has none of them or `device` is not among them; nothing runs
    in their place."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest["version"]
    if version != FORMAT_VERSION:
        age = "newer" if version > FORMAT_VERSION else "older"
        raise ValueError(f"artifact format v{version} is {age} than this loader "
                         f"(v{FORMAT_VERSION}): export the program again with this version")
    platforms = manifest["platforms"]
    if device is None:
        have = [p for p in platforms if _has(p)]
        if not have:
            raise RuntimeError(f"artifact {path!r} was exported for {platforms}, none of which "
                               "this machine has")
        device = have[0]
    device = torch.device(device)
    if device.type not in platforms or not _has(device.type):
        raise RuntimeError(f"artifact {path!r} was exported for {platforms}: it cannot run on "
                           f"{device.type} here")
    module = torch.export.load(os.path.join(path, f"fwd.{device.type}.pt2")).module()
    state = torch.load(os.path.join(path, "state.pt"), map_location=device, weights_only=True)
    params = _param_dict(state["params"])
    opt = make_optimizer(params, manifest["lr"], manifest["weight_decay"])
    opt.load_state_dict(state["opt_state"])
    return ExportedModel(path=path, manifest=manifest, module=module, params=params, opt=opt,
                         feats=state["feats"], labels=state["labels"],
                         train_mask=state["train_mask"], test_mask=state["test_mask"],
                         device=device)
