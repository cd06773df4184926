"""Per-slot weights of dynamic neighbor sampling: their plain PyTorch
version, the input check the sampled SpMM shares, and the CPU dispatch.

Dynamic sampling (`aggrFn=aggrFn.sample(k).dynamic()`) sums, for each row
of degree d, the k neighbors at in-row positions (ra*i + rb) mod d,
i < k, with repetition, under a fresh (ra, rb) each epoch.  That sum is
the row's ordinary aggregation with slot weights

    w(d, p) = #{i < k : (ra*i + rb) mod d == p}    (0 where d <= 0)

times the structural values on 'bell' (as gala_tpu's _dyn_reweight) and
alone on the edge-list layouts (as its _sampled_ell, whose values are 1).
Replaces gala_tpu's XLA _dyn_counts / _dyn_reweight
(gala_tpu/ops/spmm.py:894-923), not a Pallas kernel.

On the card no kernel of its own computes them: the bell SpMM kernel's
sampled form (`ops.kernels.bell_spmm.bell_spmm_sampled`, C entries
gala_bell_spmm_dyn_f32 / _bf16 in `gala_tpu_torch/csrc/bell_spmm.cu`)
computes each slot's weight in the staging step where it would load the
slot's value, so no (S,) weights tensor is written and read again; its
note says what bounds it.  So `dyn_weights` runs the plain version on CPU
tensors and raises on CUDA tensors, naming the fused SpMM;
`dyn_weights_reference` is what the sampled SpMM's CPU path runs and
what the card's checks hold the fused form to.  Each weight is a count
(a small integer, exact in f32) times one value, so the two forms give
the same f32 bits.  (ra, rb) are Python ints, passed to the kernel as
scalars; ra*(k-1) + rb must fit an int32, as in gala_tpu's int32
arithmetic (97*k + 97 for dynamic_sample_params' pairs).  `counts`
records plain-version calls on CUDA tensors (it has no launches).
"""
from __future__ import annotations

import torch

from gala_tpu_torch.ops.kernels._build import counts_for

_INT32_MAX = 2**31 - 1

counts = counts_for("dyn_weights")


def dyn_weights_reference(deg: torch.Tensor, pos: torch.Tensor, k: int, ra: int, rb: int,
                          vals: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch weights: the count of i < k with (ra*i + rb) mod
    max(deg, 1) == pos, in f32, 0 where deg <= 0, times `vals` where
    given (gala_tpu's jnp.where(d > 0, _dyn_counts, 0) * v)."""
    if deg.is_cuda:
        counts.reference_calls_on_cuda += 1
    d1, p = deg.long().clamp_min(1), pos.long()
    w = torch.zeros(deg.shape, dtype=torch.float32, device=deg.device)
    for i in range(k):
        w += (torch.remainder(ra * i + rb, d1) == p).float()
    w = torch.where(deg > 0, w, torch.zeros_like(w))
    return w if vals is None else w * vals


def _check(deg, pos, k, ra, rb, vals) -> None:
    for name, t in (("deg", deg), ("pos", pos)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"dyn_weights takes contiguous 1-D int32 {name}")
    if pos.shape != deg.shape or pos.device != deg.device:
        raise ValueError(f"pos {tuple(pos.shape)} on {pos.device}, deg {tuple(deg.shape)} "
                         f"on {deg.device}")
    if vals is not None and (vals.dtype != torch.float32 or vals.shape != deg.shape
                             or not vals.is_contiguous() or vals.device != deg.device):
        raise ValueError(f"vals must be a contiguous f32 {tuple(deg.shape)} tensor on "
                         f"{deg.device}")
    if k < 0 or ra < 0 or rb < 0:
        raise ValueError(f"dyn_weights takes k, ra, rb >= 0, got {k}, {ra}, {rb}")
    if ra * max(k - 1, 0) + rb > _INT32_MAX:
        raise ValueError(f"ra * (k - 1) + rb = {ra * (k - 1) + rb} overflows int32 "
                         "(gala_tpu samples in int32)")


def dyn_weights(deg: torch.Tensor, pos: torch.Tensor, k: int, ra: int, rb: int,
                vals: torch.Tensor | None = None) -> torch.Tensor:
    """(S,) f32 sampling weights of one epoch's (ra, rb) for slots at
    in-row position `pos` of rows of degree `deg` (ops.graph.DynSlots),
    times the slots' `vals` where given: the plain version on CPU
    tensors.  On CUDA tensors it raises: the card computes the weights
    inside the sampled SpMM (ops.kernels.bell_spmm.bell_spmm_sampled)."""
    k, ra, rb = int(k), int(ra), int(rb)
    _check(deg, pos, k, ra, rb, vals)
    if deg.device.type == "cpu":
        return dyn_weights_reference(deg, pos, k, ra, rb, vals)
    if deg.device.type == "cuda":
        raise RuntimeError("dyn_weights has no kernel of its own on the card: the sampled SpMM "
                           "computes the weights in its staging "
                           "(ops.kernels.bell_spmm.bell_spmm_sampled)")
    raise ValueError(f"dyn_weights runs on cpu tensors, got {deg.device}")
