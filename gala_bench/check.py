"""The comparison that decides `correct`: the program's first training
steps against the plain reference's (reference.follow), on the same
graph, features and initial weights.

The numbers, each held to the cell's limit where checks/<cell>.json
gives one:
- loss_gap: the widest relative gap of a step's loss, over the first
  steps of the set-up's job and of the window's last job;
- grad_gap: the worst leaf's gap between the norms of the gradient as
  Adam took it in step 1 (its first moment over 1 - beta1), against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; grad_gap_med, the median of the leaves' gaps, a number steady
  from seed to seed where one small leaf's gap swings (a bias under a
  ReLU, whose gradient moves by whole rows as units cross the kink);
- change_gap: the same of each leaf's change over the steps, leaving out
  the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move under Adam by round-off alone).
A missing or non-finite reading fails the check.
"""
from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap of norms, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    floor = statistics.median([ref[k] for k in names]) if names else 0.0
    return [abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in names]


def gaps(prog_losses: list, prog_grads: dict, prog_params: dict, ref, start: dict,
         raw_ref_grads: dict, steps: int) -> dict:
    """The three numbers.  prog_losses: lists of per-step losses of the
    program's jobs; prog_grads / prog_params: {leaf: tensor} read from
    the set-up's job; ref: reference.Readings; start: the initial
    weights by leaf; raw_ref_grads: the reference's step-1 gradients."""
    out = {}
    if ref.losses and all(len(ls) >= steps for ls in prog_losses) and prog_losses:
        out["loss_gap"] = max(abs(ls[i] - ref.losses[i]) / abs(ref.losses[i])
                              for ls in prog_losses for i in range(steps))
    names = sorted(ref.grads)
    if prog_grads and set(prog_grads) == set(names):
        leaf = _leaf_gaps(_norms(prog_grads), _norms(ref.grads), names)
        out["grad_gap"] = max(leaf)
        out["grad_gap_med"] = statistics.median(leaf)
    if prog_params and set(prog_params) == set(names):
        raw = _norms(raw_ref_grads)
        med = statistics.median(raw.values())
        moved = [k for k in names if raw[k] >= NOUGHT * med]
        d_prog = _norms({k: prog_params[k] - start[k] for k in moved})
        d_ref = _norms({k: ref.params[k] - start[k] for k in moved})
        out["change_gap"] = max(_leaf_gaps(d_prog, d_ref, moved), default=float("nan"))
    return out


def judge(numbers: dict, limits: dict) -> bool:
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
