"""Binned-ELL SpMM: the hand-written Hopper kernel, its build, its wrapper
and its plain PyTorch version.

Replaces gala_tpu/ops/pallas/bell_spmm.py::bell_spmm_planned (and, in
the default JAX path, the XLA gathers of gala_tpu.ops.spmm._bell_raw).
The kernel (`gala_tpu_torch/csrc/bell_spmm.cu`) covers a whole layout in
one launch from per-row descriptors (ops.graph.BellDev.row_*); its note
says what bounds it on the H100 and what the design does about that.

Build: nvcc for sm_90a into a shared library with a plain C interface,
loaded with ctypes, at first use, into `gala_tpu_torch/_build/`
(git-ignored).  The library's name carries a hash of the source, so an
edited source is rebuilt.

Dispatch (`bell_spmm`): a CPU tensor runs `bell_spmm_reference`; a CUDA
tensor runs the kernel or raises (no fallback).  `counts` records
kernel launches and plain-version calls on CUDA tensors, so a run can
show that its aggregations went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_PKG, "csrc", "bell_spmm.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_MAX_SLOTS = 2**31 - 1  # int32 slot offsets


@dataclasses.dataclass
class Counts:
    launches: int = 0                 # kernel launches
    reference_calls_on_cuda: int = 0  # plain-version calls on CUDA tensors

    def reset(self) -> None:
        self.launches = 0
        self.reference_calls_on_cuda = 0


counts = Counts()


@dataclasses.dataclass
class Build:
    lib: ctypes.CDLL
    path: str
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register and spill report)


_build: Build | None = None


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    global _build
    if _build is not None:
        return _build
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    path = os.path.join(_BUILD_DIR, f"libbell_spmm_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the bell SpMM kernel cannot be built")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SRC}:\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.gala_bell_spmm_f32.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gala_bell_spmm_f32.restype = ctypes.c_int
    _build = Build(lib=lib, path=path, seconds=seconds, log=log)
    return _build


def bell_spmm_reference(bell, x: torch.Tensor, n_out_pad: int) -> torch.Tensor:
    """Plain PyTorch binned-ELL SpMM (gala_tpu.ops.spmm._bell_raw): per
    degree-class bin an index_select and a weighted sum, hub partials
    summed over big_vrow, rows reordered by out_index, diag*x added.
    Output in global node order, padded to n_out_pad rows."""
    if x.is_cuda:
        counts.reference_calls_on_cuda += 1
    f = x.shape[1]

    def reduce(off, nb, k, vals):
        cols = bell.flat_cols[off : off + nb * k]
        seg = x.index_select(0, cols).view(nb, k, f)
        return (seg * vals.to(x.dtype).unsqueeze(-1)).sum(dim=1)

    parts, off = [], 0
    for k, nb, vals in zip(bell.bin_ks, bell.bin_counts, bell.bin_vals):
        parts.append(reduce(off, nb, k, vals))
        off += nb * k
    if bell.n_big:
        vb, kb = bell.big_vals.shape
        partial = reduce(off, vb, kb, bell.big_vals)
        hub = torch.zeros((bell.n_big, f), dtype=x.dtype, device=x.device)
        parts.append(hub.index_add_(0, bell.big_vrow, partial))
    out = torch.cat(parts, dim=0)
    if bell.out_index is not None:
        # bin order -> global order; padding rows read the appended 0 row
        out = torch.cat([out, out.new_zeros((1, f))], dim=0)
        out = out.index_select(0, bell.out_index)
    elif n_out_pad > out.shape[0]:
        out = torch.cat([out, out.new_zeros((n_out_pad - out.shape[0], f))], dim=0)
    if bell.diag is not None:
        out = out + bell.diag.to(x.dtype) * x
    return out


def _check(bell, x: torch.Tensor, n_out_pad: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"bell_spmm takes float32 features, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("bell_spmm takes a contiguous 2-D (rows, F) tensor")
    if bell.flat_cols.device != x.device:
        raise ValueError(f"layout on {bell.flat_cols.device}, features on {x.device}")
    if x.shape[0] < bell.n_src:
        raise ValueError(f"features have {x.shape[0]} rows, the layout reads {bell.n_src}")
    if n_out_pad < bell.n_real:
        raise ValueError(f"n_out_pad {n_out_pad} < {bell.n_real} real rows")
    if bell.out_index is not None and bell.out_index.shape[0] != n_out_pad:
        raise ValueError(f"n_out_pad {n_out_pad} != out_index rows {bell.out_index.shape[0]}")
    if bell.diag is not None and bell.diag.shape[0] != x.shape[0]:
        raise ValueError("a layout with a diagonal needs as many feature rows as output rows")
    if bell.flat_cols.shape[0] > _MAX_SLOTS:
        raise NotImplementedError(
            "more than 2^31 slots needs int64 slot offsets: ROADMAP Queue 1 item 9"
        )


def bell_spmm(bell, x: torch.Tensor, n_out_pad: int) -> torch.Tensor:
    """out = A @ x on a binned-ELL layout (ops.graph.BellDev): the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    _check(bell, x, n_out_pad)
    if x.device.type == "cpu":
        return bell_spmm_reference(bell, x, n_out_pad)
    if x.device.type != "cuda":
        raise ValueError(f"bell_spmm runs on cpu or cuda tensors, got {x.device}")
    lib = build().lib
    f = x.shape[1]
    out = torch.zeros((n_out_pad, f), dtype=torch.float32, device=x.device)
    n_rows = bell.row_node.shape[0]
    if n_rows == 0 or f == 0:
        return out
    vec = 4 if f % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    diag = bell.diag.data_ptr() if bell.diag is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gala_bell_spmm_f32(
            x.data_ptr(), bell.flat_cols.data_ptr(), bell.flat_vals.data_ptr(),
            bell.row_start.data_ptr(), bell.row_len.data_ptr(),
            bell.row_node.data_ptr(), diag, out.data_ptr(),
            n_rows, f, vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"bell_spmm kernel launch failed with CUDA error {err}")
    counts.launches += 1
    return out
