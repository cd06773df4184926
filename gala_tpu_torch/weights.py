"""Moving parameters between gala_tpu and gala_tpu_torch.

Both packages keep a linear layer as {"w": (d_in, d_out), "b": (d_out,)}
and GIN's learned epsilon as a bare 0-d array, so the copy is exact in
both directions.  The compiled models' params are flat ({name: {"w",
"b"}} and {f"eps{l}": 0-d}); the hand models' may nest dicts and lists
(models/gat: {"fc": [...], "attn_l": [...], "attn_r": [...]}; models/gin:
{"fc": [...], "eps": [0-d, ...]}).  A dict of arrays becomes an
nn.ParameterDict, any other dict a models.common.ParamDict, a list of
arrays an nn.ParameterList and any other list an nn.ModuleList.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gala_tpu_torch.models.common import ParamDict


def _is_leaf(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _from_jax(tree):
    if _is_leaf(tree):
        return nn.Parameter(torch.from_numpy(np.array(tree, np.float32)))
    leaves = all(_is_leaf(v) for v in (tree.values() if isinstance(tree, dict) else tree))
    if isinstance(tree, dict):
        kind = nn.ParameterDict if leaves else ParamDict
        return kind({k: _from_jax(v) for k, v in tree.items()})
    kind = nn.ParameterList if leaves else nn.ModuleList
    return kind([_from_jax(v) for v in tree])


def params_from_jax(params_np: dict, device="cpu") -> ParamDict:
    """gala_tpu params (nested dicts and lists of numpy arrays, e.g. after
    jax.device_get) -> the port's params on `device`."""
    return ParamDict({k: _from_jax(v) for k, v in params_np.items()}).to(device)


def params_to_numpy(params):
    """The port's params -> the same nesting of dicts and lists of numpy
    arrays as gala_tpu's."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    if isinstance(params, (nn.ModuleList, nn.ParameterList)):
        return [params_to_numpy(v) for v in params]
    return {k: params_to_numpy(v) for k, v in params.items()}


def shard_params(params_np: dict, plan: dict | None, mesh) -> ParamDict:
    """gala_tpu params (numpy, full size) -> the port's params of one rank
    of `mesh` (parallel.mesh), on its device: under a TP plan
    (parallel.tp.plan_tp) each planned linear layer's slice for the rank's
    model coordinate (parallel.tp.rank_slice), every other parameter
    whole; without one, params_from_jax."""
    from gala_tpu_torch.parallel.tp import rank_slice

    m, n_model = mesh.coords[1], mesh.shape["model"]
    plan = plan or {}
    sliced = {k: {key: rank_slice(plan[k], key, np.asarray(a), m, n_model)
                  for key, a in v.items()} if k in plan else v
              for k, v in params_np.items()}
    return params_from_jax(sliced, mesh.device)
