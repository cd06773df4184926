"""Shared model plumbing: parameter init, FFN, normalization helpers (the
port of gala_tpu.models.common).

Parameters keep gala_tpu's layout, {name: {"w": (d_in, d_out), "b":
(d_out,)}}, held as an `nn.ModuleDict` of `nn.ParameterDict`s, so JAX
weights copy over exactly (gala_tpu_torch.weights).  Initialization is
torch's `nn.Linear` law, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
bias, drawn from an explicit `torch.Generator`.

Matmuls run in full float32: TF32 is switched off wherever the port
multiplies (gala_tpu uses Precision.HIGHEST for the same reason).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from gala_tpu_torch.ops.graph import Graph


def full_precision_matmuls() -> None:
    """Full f32 matmuls and convolutions (no TF32), matching gala_tpu's
    Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
