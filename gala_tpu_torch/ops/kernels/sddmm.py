"""SDDMM (per-edge dot products): the hand-written Hopper kernel, its
build, its wrapper and its plain PyTorch version.

Replaces gala_tpu/ops/pallas/sddmm.py::sddmm_planned (and, in the
default JAX path, the XLA two-gather form of
gala_tpu.ops.spmm.sddmm_edges).  Convention, sddmm_edges's (the Pallas
kernel names its operands the other way round, `a` by destination):

    out[e] = <a[src[e]], b[dst[e]]>     f32, one value per listed edge

The kernel (`gala_tpu_torch/csrc/sddmm.cu`) splits the work by edges, a
group of lanes per edge; its note says what bounds it on the H100.  Built
like the other kernels: nvcc for sm_90a into a plain-C shared library in
`gala_tpu_torch/_build/` (git-ignored) at first use, loaded with ctypes
by `ops.kernels._build.build_library`.

Dispatch (`sddmm`): a CPU tensor runs `sddmm_reference`; a CUDA tensor
runs the kernel or raises (no fallback).  `counts` records kernel
launches and plain-version calls on CUDA tensors.
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.kernels._build import CSRC_DIR, Build, build_library, counts_for

_SRC = os.path.join(CSRC_DIR, "sddmm.cu")
_MAX_EDGES = 2**31 - 1  # int32 edge ids

counts = counts_for("sddmm")


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "sddmm", {
        "gala_sddmm_f32": [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    })


def sddmm_reference(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SDDMM: (a[src] * b[dst]).sum(-1), with its two
    (E, F) temporaries."""
    if a.is_cuda:
        counts.reference_calls_on_cuda += 1
    return (a.index_select(0, src) * b.index_select(0, dst)).sum(-1)


def _check(src, dst, a, b) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"sddmm takes float32 operands, got {a.dtype} and {b.dtype}")
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
    if src.shape[0] > _MAX_EDGES:
        raise NotImplementedError(
            "more than 2^31 edges needs int64 edge ids: ROADMAP Queue 1 item 9")


def sddmm(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """out[e] = <a[src[e]], b[dst[e]]>, (E,) f32: the kernel on CUDA
    tensors, the plain version on CPU tensors.  Every src must be a row of
    a and every dst a row of b (a Graph's padded edge lists are, for
    (c_pad, F) and (n_pad, F) operands); the kernel does not check."""
    _check(src, dst, a, b)
    if a.device.type == "cpu":
        return sddmm_reference(src, dst, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"sddmm runs on cpu or cuda tensors, got {a.device}")
    lib = build().lib
    n_edges, f = src.shape[0], a.shape[1]
    if f == 0:
        return torch.zeros(n_edges, dtype=torch.float32, device=a.device)
    out = torch.empty(n_edges, dtype=torch.float32, device=a.device)
    if n_edges == 0:
        return out
    vec = 4 if f % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.gala_sddmm_f32(a.data_ptr(), b.data_ptr(), src.data_ptr(), dst.data_ptr(),
                                 out.data_ptr(), n_edges, f, vec, stream)
    if err != 0:
        raise RuntimeError(f"sddmm kernel launch failed with CUDA error {err}")
    counts.launches += 1
    return out
