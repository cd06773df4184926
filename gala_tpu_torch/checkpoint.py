"""Checkpoint / resume of params and optimizer state (the port of
gala_tpu.checkpoint).

One `torch.save` file holds the params' `state_dict` (GIN's bare
epsilons among them; f32, also in a bf16 program), the optimizer's
`state_dict` (Adam's per-parameter moments and step), the names of the
parameters in the order the optimizer's state is keyed by, and `step`.
It is read back with `torch.load(weights_only=True)`: tensors and plain
containers only, no pickled code.  A missing file, other parameter
names or shapes, or a checkpoint without the optimizer state a resume
needs raise; nothing falls back to fresh weights.
"""
from __future__ import annotations

import os

import torch
from torch import nn


def save_checkpoint(path: str, params: nn.Module, opt_state: dict | None = None,
                    step: int = 0) -> str:
    """Write params, the optimizer's state_dict (if given) and `step` to
    `path` and return `path`.  The file is written beside it and renamed
    into place, so a crash while saving leaves the previous checkpoint."""
    payload = {
        "params": params.state_dict(),
        "param_names": [name for name, _ in params.named_parameters()],
        "opt_state": opt_state,
        "step": int(step),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, like=None) -> dict:
    """Load a checkpoint written by save_checkpoint: {"params": state_dict,
    "param_names", "opt_state", "step"}.

    like: optional {"params": nn.Module}: the params are copied into that
    module in place (strict: the same names and shapes, else it raises)
    and the result's "params" is the module."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if like is not None and like.get("params") is not None:
        module = like["params"]
        names = [name for name, _ in module.named_parameters()]
        if names != state["param_names"]:
            raise ValueError(f"checkpoint {path!r} holds parameters {state['param_names']}, "
                             f"the model {names}")
        module.load_state_dict(state["params"], strict=True)
        state["params"] = module
    return state


def restore(path: str, params: nn.Module, opt: torch.optim.Optimizer) -> None:
    """Resume from `path`: params in place and the optimizer's state (its
    moments and step continue, so Adam's bias corrections do)."""
    state = load_checkpoint(path, like={"params": params})
    if state["opt_state"] is None:
        raise ValueError(f"checkpoint {path!r} holds no optimizer state to resume from")
    opt.load_state_dict(state["opt_state"])
