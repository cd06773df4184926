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


def _map_leaves(fn, tree):
    if _is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return [_map_leaves(fn, v) for v in tree]


def _first_leaf(tree):
    while not _is_leaf(tree):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _stage_layers(tree, n_stages: int) -> bool:
    """A tree keyed by stage layer, "l1" .. "lP" (gala_tpu's pipelined
    SAGE: layer i + 1 lives on stage i, zero slices on the others)."""
    return isinstance(tree, dict) and set(tree) == {f"l{i + 1}" for i in range(n_stages)}


def stage_params_from_jax(stacked_np: dict, stage: int, device="cpu") -> ParamDict:
    """The stacked pipeline params of gala_tpu (every leaf with a leading
    axis P, gala_tpu.parallel.pp.stack_stage_params) -> the port's params
    of one stage (parallel.pp) on `device`: each leaf's slice `stage`.  A
    tree keyed by layer, "l1" .. "lP", keeps only the stage's own layer:
    the others are gala_tpu's zero off-stage slices."""
    n_stages = int(np.shape(_first_leaf(stacked_np))[0])
    tree = _map_leaves(lambda a: np.asarray(a)[stage], stacked_np)
    if _stage_layers(tree, n_stages):
        tree = {f"l{stage + 1}": tree[f"l{stage + 1}"]}
    return params_from_jax(tree, device)


def stage_params_to_jax(per_stage: list) -> dict:
    """stage_params_from_jax's inverse: every stage's params (the port's)
    -> gala_tpu's stacked tree, a layer a stage lacks as zeros."""
    trees = [params_to_numpy(s) for s in per_stage]
    keys = [f"l{i + 1}" for i in range(len(trees))]
    if [list(t) for t in trees] == [[k] for k in keys]:
        full = {k: t[k] for k, t in zip(keys, trees)}
        trees = [{k: t.get(k, _map_leaves(np.zeros_like, full[k])) for k in keys} for t in trees]

    def stack(ts):
        first = ts[0]
        if _is_leaf(first):
            return np.stack(ts)
        if isinstance(first, dict):
            return {k: stack([t[k] for t in ts]) for k in first}
        return [stack([t[i] for t in ts]) for i in range(len(first))]

    return stack(trees)
