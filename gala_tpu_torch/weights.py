"""Moving parameters between gala_tpu and gala_tpu_torch.

Both packages keep a linear layer as {"w": (d_in, d_out), "b": (d_out,)},
so the copy is exact in both directions.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_jax(params_np: dict, device="cpu") -> nn.ModuleDict:
    """gala_tpu params ({name: {"w", "b"}} of numpy arrays, e.g. after
    jax.device_get) -> the port's params on `device`."""
    out = nn.ModuleDict()
    for name, layer in params_np.items():
        out[name] = nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(np.array(v, np.float32)))
            for k, v in layer.items()
        })
    return out.to(device)


def params_to_numpy(params) -> dict:
    """The port's params -> {name: {"w", "b"}} of numpy arrays."""
    return {
        name: {k: v.detach().cpu().numpy() for k, v in layer.items()}
        for name, layer in params.items()
    }
