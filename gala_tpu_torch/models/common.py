"""Shared model plumbing: parameter init, FFN, normalization helpers (the
port of gala_tpu.models.common).

Parameters keep gala_tpu's layout, {name: {"w": (d_in, d_out), "b":
(d_out,)}} plus GIN's learned epsilons as bare 0-d leaves, held as a
`ParamDict` of `nn.ParameterDict`s and parameters, so JAX weights copy
over exactly (gala_tpu_torch.weights).  Initialization is
torch's `nn.Linear` law, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
bias, drawn from an explicit `torch.Generator`.

Matmuls run in full float32: TF32 is switched off wherever the port
multiplies (gala_tpu uses Precision.HIGHEST for the same reason).

Mixed precision, as gala_tpu's dtype=jnp.bfloat16: parameters, optimizer
state and the loss stay f32; the features are cast to the activation
dtype (`activation_dtype`) and each FFN casts its parameters to its
input's dtype, so gradients reach the f32 parameters in f32.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from gala_tpu_torch.ops.graph import Graph


_ACTIVATION_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def activation_dtype(dtype) -> torch.dtype | None:
    """The torch dtype of an entry point's `dtype=` (None: the features'
    own f32): torch.float32 or torch.bfloat16, their names, or numpy's
    float32.  Raises TypeError on any other."""
    if isinstance(dtype, torch.dtype):
        key = str(dtype).removeprefix("torch.")
    else:
        key = getattr(dtype, "__name__", dtype)
    if key not in _ACTIVATION_DTYPES:
        raise TypeError(f"activations run in float32 or bfloat16, got dtype {dtype!r}")
    return _ACTIVATION_DTYPES[key]


def full_precision_matmuls() -> None:
    """Full f32 matmuls and convolutions (no TF32), matching gala_tpu's
    Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class ParamDict(nn.ModuleDict):
    """An nn.ModuleDict that also holds bare parameters, so a params tree
    keeps gala_tpu's nesting where a dict mixes sub-trees and scalar
    leaves (a compiled GIN's {"weight1": {w, b}, "eps1": 0-d, ...}).
    Sub-modules come first in iteration order, then the parameters."""

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, nn.Parameter):
            self.register_parameter(key, value)
        else:
            super().__setitem__(key, value)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules

    def __len__(self) -> int:
        return len(self._modules) + len(self._parameters)

    def __iter__(self):
        return iter([*self._modules, *self._parameters])

    def keys(self):
        return list(self)

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]


def epsilon_param() -> nn.Parameter:
    """GIN's learned epsilon: a 0-d f32 parameter, 0 at init as in gala_tpu."""
    return nn.Parameter(torch.zeros((), dtype=torch.float32))


def scale_by_eps(eps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(1 + eps) * x with JAX's promotion: gala_tpu's learned epsilon is a
    strongly typed 0-d f32 array, so bf16 x yields f32 there, where torch
    would keep x's dtype for a 0-d operand."""
    return (1.0 + eps) * x.to(torch.promote_types(eps.dtype, x.dtype))


def linear_init(gen: torch.Generator, d_in: int, d_out: int) -> nn.ParameterDict:
    """torch nn.Linear default init (bound 1/sqrt(fan_in)), drawn on the
    CPU from `gen` so the values do not depend on the device."""
    bound = 1.0 / math.sqrt(max(d_in, 1))
    w = torch.empty((d_in, d_out), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    b = torch.empty((d_out,), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    return nn.ParameterDict({"w": nn.Parameter(w), "b": nn.Parameter(b)})


def linear(p, x: torch.Tensor) -> torch.Tensor:
    full_precision_matmuls()
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def gcn_norm(g: Graph, power: float = -0.5) -> torch.Tensor:
    """norm = deg^power, detached; zero-degree (padding) rows get 0."""
    deg = g.deg
    safe = torch.where(deg > 0, deg, torch.ones_like(deg))
    return torch.where(deg > 0, safe.pow(power), torch.zeros_like(deg)).detach()


def layer_sizes(n_feats: int, hidden: list[int], n_classes: int) -> list[tuple[int, int]]:
    """Per-layer (d_in, d_out) from feature size, hidden dims, label size."""
    dims = [n_feats, *hidden, n_classes]
    return list(zip(dims[:-1], dims[1:]))
