"""Binned-ELL SpMM: the hand-written Hopper kernel, its build, its wrapper
and its plain PyTorch versions.

Replaces gala_tpu/ops/pallas/bell_spmm.py::bell_spmm_planned (and, in
the default JAX path, the XLA gathers of gala_tpu.ops.spmm._bell_raw).
The kernel (`gala_tpu_torch/csrc/bell_spmm.cu`) covers a whole layout in
one launch from per-row descriptors (ops.graph.BellDev.row_*); its note
says what bounds it on the H100 and what the design does about that.

Build: nvcc for sm_90a into a shared library with a plain C interface,
loaded with ctypes, at first use, into `gala_tpu_torch/_build/`
(git-ignored), by `ops.kernels._build.build_library`.

The kernel reads any layout through its row descriptors, so it also
executes the 'ell' and 'segment' layouts (ops.graph.SlotRows), with
their structural values or with per-slot values passed as `vals` (the
learned-edge-value SpMM of ops.spmm.spmm_ev).

Dispatch (`bell_spmm`): a CPU tensor runs a plain version, the
bin-by-bin `bell_spmm_reference` for a binned layout with its own values
and the slot-by-slot `bell_spmm_rows_reference` for every other call; a
CUDA tensor runs the kernel or raises (no fallback).  `counts` records
kernel launches and plain-version calls on CUDA tensors, so a run can
show that its aggregations went through the kernel.
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.graph import BellDev
from gala_tpu_torch.ops.kernels._build import CSRC_DIR, Build, build_library, counts_for

_SRC = os.path.join(CSRC_DIR, "bell_spmm.cu")
_MAX_SLOTS = 2**31 - 1  # int32 slot offsets

counts = counts_for("bell_spmm")


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "bell_spmm", {
        "gala_bell_spmm_f32": [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ],
    })


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


def bell_spmm_rows_reference(layout, x: torch.Tensor, n_out_pad: int,
                             vals: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch SpMM from the row descriptors, for any layout the
    kernel takes (ops.graph.BellDev or SlotRows): every described slot
    gathers its row of x, weighted by its value (`vals`, or the layout's
    flat_vals), and is summed into its row's node with index_add_; the
    diag*x term added.  Slots no descriptor names are not read.  Output
    in global node order, padded to n_out_pad rows."""
    if x.is_cuda:
        counts.reference_calls_on_cuda += 1
    vals = layout.flat_vals if vals is None else vals
    lens = layout.row_len.long()
    row = torch.repeat_interleave(torch.arange(lens.shape[0], device=x.device), lens)
    first = torch.cumsum(lens, 0) - lens
    slot = layout.row_start.long()[row] + torch.arange(row.shape[0], device=x.device) - first[row]
    msg = vals[slot].to(x.dtype).unsqueeze(1) * x.index_select(0, layout.flat_cols[slot])
    out = torch.zeros((n_out_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_add_(0, layout.row_node[row], msg)
    if layout.diag is not None:
        out = out + layout.diag.to(x.dtype) * x
    return out


def _check(bell, x: torch.Tensor, n_out_pad: int, vals: torch.Tensor | None) -> None:
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
    if vals is not None:
        if vals.dtype != torch.float32:
            raise TypeError(f"bell_spmm takes float32 slot values, got {vals.dtype}")
        if vals.shape != bell.flat_vals.shape or not vals.is_contiguous():
            raise ValueError(f"slot values must be a contiguous {tuple(bell.flat_vals.shape)} "
                             f"tensor, got {tuple(vals.shape)}")
        if vals.device != x.device:
            raise ValueError(f"slot values on {vals.device}, features on {x.device}")


def bell_spmm(bell, x: torch.Tensor, n_out_pad: int,
              vals: torch.Tensor | None = None) -> torch.Tensor:
    """out = A @ x on a row-descriptor layout (ops.graph.BellDev or
    SlotRows), A's values the layout's flat_vals or, when given, `vals`
    (one f32 per slot): the kernel on a CUDA tensor, a plain version on a
    CPU tensor."""
    _check(bell, x, n_out_pad, vals)
    if x.device.type == "cpu":
        if vals is None and isinstance(bell, BellDev):
            return bell_spmm_reference(bell, x, n_out_pad)
        return bell_spmm_rows_reference(bell, x, n_out_pad, vals)
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
            x.data_ptr(), bell.flat_cols.data_ptr(),
            (bell.flat_vals if vals is None else vals).data_ptr(),
            bell.row_start.data_ptr(), bell.row_len.data_ptr(),
            bell.row_node.data_ptr(), diag, out.data_ptr(),
            n_rows, f, vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"bell_spmm kernel launch failed with CUDA error {err}")
    counts.launches += 1
    return out
