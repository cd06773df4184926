"""Per-slot weights of dynamic neighbor sampling: the hand-written Hopper
kernel, its build, its wrapper and its plain PyTorch version.

Dynamic sampling (`aggrFn=aggrFn.sample(k).dynamic()`) sums, for each row
of degree d, the k neighbors at in-row positions (ra*i + rb) mod d,
i < k, with repetition, under a fresh (ra, rb) each epoch.  That sum is
the row's ordinary aggregation with slot weights

    w(d, p) = #{i < k : (ra*i + rb) mod d == p}    (0 where d <= 0)

so ops.spmm.spmm_sampled runs the bell SpMM kernel with `dyn_weights`'
output as its slot values, times the structural values on 'bell' (as
gala_tpu's _dyn_reweight) and alone on the edge-list layouts (as its
_sampled_ell, whose values are 1).  Replaces gala_tpu's XLA
_dyn_counts / _dyn_reweight (gala_tpu/ops/spmm.py:894-923), not a Pallas
kernel: in eager PyTorch their loop of k elementwise steps would cost
about 3k launches per sampled SpMM call, the kernel one.

The kernel (`gala_tpu_torch/csrc/dyn_weights.cu`, one thread a slot) is
built like the other kernels: nvcc for sm_90a into a plain-C shared
library in `gala_tpu_torch/_build/` (git-ignored) at first use, loaded
with ctypes by `ops.kernels._build.build_library`.  Its note says what
bounds it on the H100.

Dispatch (`dyn_weights`): CPU tensors run `dyn_weights_reference`; CUDA
tensors run the kernel or raise (no fallback).  Both give the same f32
bits: each weight is a count (a small integer, exact in f32) times one
value.  (ra, rb) are Python ints, passed to the kernel as scalars, so no
device tensor is made per epoch; ra*(k-1) + rb must fit an int32, as in
gala_tpu's int32 arithmetic (97*k + 97 for dynamic_sample_params' pairs).
`counts` records kernel launches and plain-version calls on CUDA tensors.
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.kernels._build import CSRC_DIR, Build, build_library, counts_for

_SRC = os.path.join(CSRC_DIR, "dyn_weights.cu")
_INT32_MAX = 2**31 - 1

counts = counts_for("dyn_weights")


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "dyn_weights", {
        "gala_dyn_weights": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
    })


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
    times the slots' `vals` where given: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    k, ra, rb = int(k), int(ra), int(rb)
    _check(deg, pos, k, ra, rb, vals)
    if deg.device.type == "cpu":
        return dyn_weights_reference(deg, pos, k, ra, rb, vals)
    if deg.device.type != "cuda":
        raise ValueError(f"dyn_weights runs on cpu or cuda tensors, got {deg.device}")
    out = torch.empty(deg.shape, dtype=torch.float32, device=deg.device)
    if deg.numel() == 0:
        return out
    fn = build().lib.gala_dyn_weights
    with torch.cuda.device(deg.device):
        stream = torch.cuda.current_stream(deg.device).cuda_stream
        err = fn(deg.data_ptr(), pos.data_ptr(), vals.data_ptr() if vals is not None else None,
                 out.data_ptr(), deg.numel(), k, ra, rb, stream)
    if err != 0:
        raise RuntimeError(f"dyn_weights kernel launch failed with CUDA error {err}")
    counts.launches += 1
    return out
