"""SDDMM (per-edge dot products): the hand-written Hopper kernel, its
build, its wrapper and its plain PyTorch version.

Replaces gala_tpu/ops/pallas/sddmm.py::sddmm_planned (and, in the
default JAX path, the XLA two-gather form of
gala_tpu.ops.spmm.sddmm_edges).  Convention, sddmm_edges's (the Pallas
kernel names its operands the other way round, `a` by destination):

    out[e] = <a[src[e]], b[dst[e]]>     one value per listed edge

in the operands' dtype, float32 or bfloat16 (bf16 activations, as
gala_tpu's sddmm_edges returns them): one kernel instantiation and C entry
point each (gala_sddmm_f32, gala_sddmm_bf16), the products summed in f32
and each dot rounded once.  The plain version computes in f32 and rounds
once too.

The kernel (`gala_tpu_torch/csrc/sddmm.cu`) splits the work by edges: a
warp takes a run of 128 edges whose indices it loads once, and groups of
up to 32 lanes (one 16-byte vector of the row each: 4 f32 or 8 bf16
elements, `lane_width`) take its batches of four edges, their row
gathers in flight together, keeping b's row while the destination
repeats; its note says what bounds it on the H100.  Built like the other
kernels: nvcc for sm_90a into a plain-C shared library in `gala_tpu_torch/_build/` (git-ignored) at
first use, loaded with ctypes by `ops.kernels._build.build_library`.

Dispatch (`sddmm`, the one binding, which the custom op
`gala_tpu_torch::sddmm` of ops.kernels.library runs on either device): a
CPU tensor runs `sddmm_reference`; a CUDA tensor runs `sddmm_cuda`, the
kernel, or raises (no fallback).  `counts` records kernel
launches and plain-version calls on CUDA tensors (bf16 launches under
"sddmm_bf16", `_build.dtype_counts`).
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.kernels._build import (
    CSRC_DIR, DTYPES, Build, build_library, counts_for, launch, on_card, wide,
)
from gala_tpu_torch.ops.kernels.bell_spmm import vector_width

_SRC = os.path.join(CSRC_DIR, "sddmm.cu")

counts = counts_for("sddmm")


# the library's C functions and their argument types
FUNCTIONS = {
    f"gala_sddmm_{t}": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ] for t in DTYPES.values()
}


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "sddmm", FUNCTIONS)


def sddmm_reference(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SDDMM: (a[src] * b[dst]).sum(-1), with its two
    (E, F) temporaries, in f32 and rounded once to the operands' dtype."""
    if a.is_cuda:
        counts.reference_calls_on_cuda += 1
    return (wide(a).index_select(0, src) * wide(b).index_select(0, dst)).sum(-1).to(a.dtype)


def _check(src, dst, a, b) -> None:
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"sddmm takes two float32 or two bfloat16 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("sddmm takes contiguous 2-D (rows, F) operands")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"sddmm operands differ in width: {a.shape[1]} and {b.shape[1]}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"sddmm takes int32 edge lists, got {src.dtype} and {dst.dtype}")
    if src.dim() != 1 or src.shape != dst.shape or not (src.is_contiguous()
                                                        and dst.is_contiguous()):
        raise ValueError("sddmm takes two contiguous 1-D edge lists of one length")
    devices = {t.device for t in (src, dst, a, b)}
    if len(devices) != 1:
        raise ValueError(f"sddmm operands on several devices: {sorted(map(str, devices))}")


def lane_width(a: torch.Tensor, b: torch.Tensor) -> int:
    """The elements of a row a lane of the kernel loads: vector_width of
    both operands (16 bytes where F and both tables allow it, 4 at bf16
    where only 4 divide F, else 1)."""
    return min(vector_width(a), vector_width(b))


def sddmm_cuda(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (arguments as checked by sddmm); raises
    when the library cannot be built or the launch fails."""
    n_edges, f = src.shape[0], a.shape[1]
    if f == 0:
        return torch.zeros(n_edges, dtype=a.dtype, device=a.device)
    out = torch.empty(n_edges, dtype=a.dtype, device=a.device)
    if n_edges == 0:
        return out
    launch(build().lib, "sddmm", a, a.data_ptr(), b.data_ptr(), src.data_ptr(), dst.data_ptr(),
           out.data_ptr(), n_edges, f, lane_width(a, b))
    return out


def sddmm(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """out[e] = <a[src[e]], b[dst[e]]>, (E,) in the operands' dtype: the
    kernel on CUDA tensors, the plain version on CPU tensors.  Every src must be a row of
    a and every dst a row of b (a Graph's padded edge lists are, for
    (c_pad, F) and (n_pad, F) operands); the kernel does not check."""
    _check(src, dst, a, b)
    if on_card(a, "sddmm"):
        return sddmm_cuda(src, dst, a, b)
    return sddmm_reference(src, dst, a, b)
