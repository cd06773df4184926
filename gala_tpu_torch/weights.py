"""Moving parameters between gala_tpu and gala_tpu_torch.

Both packages keep a linear layer as {"w": (d_in, d_out), "b": (d_out,)},
so the copy is exact in both directions.  The compiled models' params are
flat ({name: {"w", "b"}}); the hand models' may nest dicts and lists
(models/gat: {"fc": [...], "attn_l": [...], "attn_r": [...]}), which
become nn.ModuleDict and nn.ModuleList here.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _is_leaf(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _from_jax(tree):
    if isinstance(tree, dict) and all(_is_leaf(v) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.from_numpy(np.array(v, np.float32)))
            for k, v in tree.items()
        })
    if isinstance(tree, dict):
        return nn.ModuleDict({k: _from_jax(v) for k, v in tree.items()})
    return nn.ModuleList([_from_jax(v) for v in tree])


def params_from_jax(params_np: dict, device="cpu") -> nn.ModuleDict:
    """gala_tpu params (nested dicts and lists of numpy arrays, e.g. after
    jax.device_get) -> the port's params on `device`."""
    return nn.ModuleDict({k: _from_jax(v) for k, v in params_np.items()}).to(device)


def params_to_numpy(params):
    """The port's params -> the same nesting of dicts and lists of numpy
    arrays as gala_tpu's."""
    if isinstance(params, nn.ParameterDict):
        return {k: v.detach().cpu().numpy() for k, v in params.items()}
    if isinstance(params, nn.ModuleList):
        return [params_to_numpy(v) for v in params]
    return {k: params_to_numpy(v) for k, v in params.items()}
