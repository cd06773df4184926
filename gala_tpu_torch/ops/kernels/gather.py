"""Row gather: the hand-written Hopper kernel, its build, its wrapper and
its plain PyTorch version.

Replaces gala_tpu/ops/pallas/gather.py::gather_rows, which computes

    out[i, :] = x[idx[i], :]

for an (N, F) table and (M,) int32 indices.  In gala_tpu only
scripts/microbench.py calls the Pallas form, and minibatch GraphSAGE
runs its three gathers through XLA; in the port this kernel executes
those gathers (gala_tpu_torch.train_minibatch.forward_minibatch).  The
kernel (`gala_tpu_torch/csrc/gather_rows.cu`) copies bytes, so it takes
f32 and bf16 tables alike and any M (the TPU form needs M % 2048 == 0);
its note says what bounds it on the H100.  Built like the other
kernels: nvcc for sm_90a into a plain-C shared library in
`gala_tpu_torch/_build/` (git-ignored) at first use, loaded with ctypes
by `ops.kernels._build.build_library`.

Dispatch (`gather_rows`, the one binding): a CPU tensor runs
`gather_rows_reference`; a CUDA tensor runs the kernel or raises (no
fallback).  The gather has no
gradient (the Pallas kernel has no VJP either): a table that requires
grad is refused.  `counts` records kernel launches and plain-version
calls on CUDA tensors.
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.kernels._build import (
    CSRC_DIR, Build, build_library, counts_for, launch, on_card,
)

_SRC = os.path.join(CSRC_DIR, "gather_rows.cu")
_DTYPES = (torch.float32, torch.bfloat16)
_VECS = (16, 8, 4, 2)  # bytes per vector access, widest first

counts = counts_for("gather_rows")


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "gather_rows", {
        "gala_gather_rows": [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ],
    })


def gather_rows_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch row gather: x.index_select(0, idx)."""
    if x.is_cuda:
        counts.reference_calls_on_cuda += 1
    return x.index_select(0, idx.long())


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"gather_rows takes a float32 or bfloat16 table, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("gather_rows takes a contiguous 2-D (N, F) table")
    if x.requires_grad:
        raise ValueError("gather_rows has no gradient: the table must not require grad")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise TypeError("gather_rows takes contiguous 1-D int32 indices")
    if x.device != idx.device:
        raise ValueError(f"gather_rows operands on {x.device} and {idx.device}")


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = x[idx[i]], (M, F) in x's dtype: the kernel on CUDA
    tensors, the plain version on CPU tensors.  Every index must lie in
    [0, N); the kernel traps on one that does not (the next synchronize
    reports it), as index_select's device assert does."""
    _check(x, idx)
    if not on_card(x, "gather_rows"):
        return gather_rows_reference(x, idx)
    m = idx.shape[0]
    out = torch.empty((m, x.shape[1]), dtype=x.dtype, device=x.device)
    row_bytes = x.shape[1] * x.element_size()
    if m == 0 or row_bytes == 0:
        return out
    vec = next(v for v in _VECS
               if row_bytes % v == 0 and x.data_ptr() % v == 0 and out.data_ptr() % v == 0)
    launch(build().lib, "gather_rows", x, x.data_ptr(), idx.data_ptr(), out.data_ptr(), m,
           x.shape[0], row_bytes, vec, record=counts)
    return out


def compare_with_plain(x: torch.Tensor, idx: torch.Tensor) -> float:
    """max |kernel - plain| on the same inputs (0.0 for a copy); raises
    unless the two are bitwise equal."""
    got = gather_rows(x, idx)
    want = gather_rows_reference(x, idx)
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"gather_rows differs from index_select: max |diff| {err}")
    return err
