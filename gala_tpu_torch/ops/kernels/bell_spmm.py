"""Binned-ELL SpMM: the hand-written Hopper kernel, its build, its wrapper
and its plain PyTorch versions.

Replaces gala_tpu/ops/pallas/bell_spmm.py::bell_spmm_planned (and, in
the default JAX path, the XLA gathers of gala_tpu.ops.spmm._bell_raw).
The kernel (`gala_tpu_torch/csrc/bell_spmm.cu`) covers a whole layout in
one call of two launches over the layout's work units
(ops.graph.WorkUnits): pass 1 reduces each unit of at most UNIT_SLOTS
slots, several short units a warp (the layout's warp table for the call's
lanes across a row, WorkUnits.warps), writing a node's row or, for a row
split into several units, one partial; pass 2 sums each split row's
partials in unit order.  The call zeroes `out` first, so the wrapper
allocates it with torch.empty.  Its note says what bounds it on the
H100 and what the design does about that.

Build: nvcc for sm_90a into a shared library with a plain C interface,
loaded with ctypes, at first use, into `gala_tpu_torch/_build/`
(git-ignored), by `ops.kernels._build.build_library`.

The kernel reads any layout through its work units, so it also executes
the 'ell' and 'segment' layouts (ops.graph.SlotRows), with their
structural values or with per-slot values passed as `vals` (the
learned-edge-value SpMM of ops.spmm.spmm_ev).

Element types: x (and out) float32 or bfloat16 (bf16 activations,
gala_tpu's dtype=jnp.bfloat16), one kernel instantiation and C entry
point each (gala_bell_spmm_f32, gala_bell_spmm_bf16).  The slot values
and diag stay f32; at bf16 they are rounded to bf16 before the multiply
(gala_tpu's vals.astype(x.dtype)), every sum is f32 and each output row
is rounded once.  The plain versions do the same: they compute in f32
from the bf16 values and round the result once, so the tests hold the
kernel to an oracle that accumulates as gala_tpu's bf16 einsums do
(preferred_element_type=f32), not to bf16 adds.

Dispatch (`bell_spmm`, the one binding, which the custom op
`gala_tpu_torch::bell_spmm` of ops.kernels.library runs on either
device): a CPU tensor runs `bell_spmm_plain`, the bin-by-bin
`bell_spmm_reference` for a binned layout with its own values and the
slot-by-slot `bell_spmm_rows_reference` for every other call; a CUDA
tensor runs `bell_spmm_cuda`, the kernel, or raises (no fallback).
`counts` records kernel calls (one per product, both passes) and
plain-version calls on CUDA tensors, so a run can show that its
aggregations went through the kernel (bf16 launches under
"bell_spmm_bf16", `_build.dtype_counts`).  `bell_spmm_units_reference`
repeats the kernel's two passes in plain PyTorch, for the tests and the
card's checks only.

Dynamic neighbor sampling (`bell_spmm_sampled`, ops.spmm.SampledSpmm's
forward and transpose; `aggrFn=aggrFn.sample(k).dynamic()`) sums, for
each row of degree d, the k neighbors at in-row positions
(ra*i + rb) mod d, i < k, with repetition, under a fresh (ra, rb) each
epoch.  That sum is the row's ordinary aggregation with slot weights

    w(d, p) = #{i < k : (ra*i + rb) mod d == p}    (0 where d <= 0)

times the structural values on 'bell' (as gala_tpu's _dyn_reweight) and
alone on the edge-list layouts (as its _sampled_ell, whose values are
1); they replace gala_tpu's XLA _dyn_counts / _dyn_reweight
(gala_tpu/ops/spmm.py:894-923), not a Pallas kernel.  On a CUDA tensor
the kernel's sampled form computes each slot's weight in pass 1's
staging, where it would load the slot's value, from the layout's
DynSlots (C entries gala_bell_spmm_dyn_f32 / _bf16, launches counted
under "bell_spmm_dyn", bf16 under "bell_spmm_dyn_bf16"), so no (S,)
weights tensor is written and read again.  On a CPU tensor the plain
weights (`dyn_weights_reference`, also what the card's checks hold the
kernel to; its calls on CUDA tensors count under "bell_spmm_dyn") go to
the row-descriptor plain version.  Each weight is a count (a small
integer, exact in f32) times one value, so both equal the SpMM with the
plain weights as its values, bit for bit.  (ra, rb) are Python ints,
passed to the kernel as scalars; ra*(k-1) + rb must fit an int32, as in
gala_tpu's int32 arithmetic (97*k + 97 for dynamic_sample_params'
pairs).
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.graph import BellDev, row_lanes
from gala_tpu_torch.ops.kernels._build import (
    CSRC_DIR, DTYPES, Build, build_library, counts_for, launch, on_card, read_limits, wide,
)

_SRC = os.path.join(CSRC_DIR, "bell_spmm.cu")
# the library's kernels, in the order of gala_bell_spmm_limits
KERNELS = ("spmm_unit_kernel<4>", "spmm_unit_kernel<1>", "spmm_merge_kernel<4>",
           "spmm_merge_kernel<1>", "spmm_unit_kernel<4> bf16", "spmm_unit_kernel<1> bf16",
           "spmm_merge_kernel<4> bf16", "spmm_merge_kernel<1> bf16", "spmm_unit_kernel<8> bf16",
           "spmm_unit_kernel<4> sampled", "spmm_unit_kernel<1> sampled",
           "spmm_unit_kernel<4> sampled bf16", "spmm_unit_kernel<1> sampled bf16",
           "spmm_unit_kernel<8> sampled bf16")

counts = counts_for("bell_spmm")
_sampled_counts = counts_for("bell_spmm_dyn")
_INT32_MAX = 2**31 - 1


# the library's C functions and their argument types
FUNCTIONS = {
    **{f"gala_bell_spmm_{t}": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
       for t in DTYPES.values()},
    **{f"gala_bell_spmm_dyn_{t}": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10
       + [ctypes.c_void_p] for t in DTYPES.values()},
    "gala_bell_spmm_limits": [ctypes.c_int, ctypes.c_void_p],
}


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "bell_spmm", FUNCTIONS)


def launch_limits() -> dict:
    """{kernel: registers, static and dynamic shared memory per block,
    resident blocks per SM} of the library's kernels, from the CUDA
    runtime (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = build().lib
    return {name: read_limits(lib.gala_bell_spmm_limits, k) for k, name in enumerate(KERNELS)}


def _values(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Slot values or diag as the product takes them: rounded to the
    activations' dtype, multiplied in at least f32."""
    return wide(v.to(dtype))


def bell_spmm_reference(bell, x: torch.Tensor, n_out_pad: int) -> torch.Tensor:
    """Plain PyTorch binned-ELL SpMM (gala_tpu.ops.spmm._bell_raw): per
    degree-class bin an index_select and a weighted sum, hub partials
    summed over big_vrow, rows reordered by out_index, diag*x added.
    Output in global node order, padded to n_out_pad rows, in x's dtype
    (computed in f32, rounded once)."""
    if x.is_cuda:
        counts.reference_calls_on_cuda += 1
    dtype, x = x.dtype, wide(x)
    f = x.shape[1]

    def reduce(off, nb, k, vals):
        cols = bell.flat_cols[off : off + nb * k]
        seg = x.index_select(0, cols).view(nb, k, f)
        return (seg * _values(vals, dtype).unsqueeze(-1)).sum(dim=1)

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
        out = out + _values(bell.diag, dtype) * x
    return out.to(dtype)


def bell_spmm_rows_reference(layout, x: torch.Tensor, n_out_pad: int,
                             vals: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch SpMM from the row descriptors, for any layout the
    kernel takes (ops.graph.BellDev or SlotRows): every described slot
    gathers its row of x, weighted by its value (`vals`, or the layout's
    flat_vals), and is summed into its row's node with index_add_; the
    diag*x term added.  Slots no descriptor names are not read.  Output
    in global node order, padded to n_out_pad rows, in x's dtype
    (computed in f32, rounded once)."""
    if x.is_cuda:
        counts.reference_calls_on_cuda += 1
    dtype, x = x.dtype, wide(x)
    vals = layout.flat_vals if vals is None else vals
    lens = layout.row_len.long()
    row = torch.repeat_interleave(torch.arange(lens.shape[0], device=x.device), lens)
    first = torch.cumsum(lens, 0) - lens
    slot = layout.row_start[row] + torch.arange(row.shape[0], device=x.device) - first[row]
    msg = _values(vals[slot], dtype).unsqueeze(1) * x.index_select(0, layout.flat_cols[slot])
    out = torch.zeros((n_out_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    out.index_add_(0, layout.row_node[row], msg)
    if layout.diag is not None:
        out = out + _values(layout.diag, dtype) * x
    return out.to(dtype)


def unit_slots(units, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(unit of each slot, slot index) over the work units' slots, unit by
    unit in table order: what pass 1 reads."""
    lens = units.length.long()
    unit = torch.repeat_interleave(torch.arange(lens.shape[0], device=device), lens)
    first = torch.cumsum(lens, 0) - lens
    slot = units.start.long()[unit] + torch.arange(unit.shape[0], device=device) - first[unit]
    return unit, slot


def bell_spmm_units_reference(layout, x: torch.Tensor, n_out_pad: int,
                              vals: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's two passes in plain PyTorch (for tests and the card's
    checks): pass 1 sums each work unit's weighted rows of x; a unit that
    is its whole row writes its node with diag*x, the others fill their
    partial rows; pass 2 sums each split row's partials in unit order and
    adds diag*x.  The same function as bell_spmm_rows_reference, in f32
    with one rounding to x's dtype at the end."""
    units = layout.units
    vals = layout.flat_vals if vals is None else vals
    dtype, x = x.dtype, wide(x)
    f = x.shape[1]
    unit, slot = unit_slots(units, x.device)
    msg = _values(vals[slot], dtype).unsqueeze(1) * x.index_select(0, layout.flat_cols[slot])
    acc = torch.zeros((units.n_units, f), dtype=x.dtype, device=x.device).index_add_(0, unit, msg)
    diag = (_values(layout.diag, dtype) * x) if layout.diag is not None else None
    out = torch.zeros((n_out_pad, f), dtype=x.dtype, device=x.device)
    whole = units.part < 0
    node = units.node[whole].long()
    out[node] = acc[whole] + (diag[node] if diag is not None else 0)
    if units.n_partials:
        part = torch.empty((units.n_partials, f), dtype=x.dtype, device=x.device)
        part[units.part[~whole].long()] = acc[~whole]
        owner = torch.repeat_interleave(
            torch.arange(units.split_node.shape[0], device=x.device), units.split_count.long())
        merged = torch.zeros((units.split_node.shape[0], f), dtype=x.dtype,
                             device=x.device).index_add_(0, owner, part)
        node = units.split_node.long()
        out[node] = merged + (diag[node] if diag is not None else 0)
    return out.to(dtype)


def _check(bell, x: torch.Tensor, n_out_pad: int, vals: torch.Tensor | None) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"bell_spmm takes float32 or bfloat16 features, got {x.dtype}")
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
    if bell.units.start.dtype != torch.int64:
        raise TypeError(f"work-unit starts must be int64, got {bell.units.start.dtype}")
    if vals is not None:
        if vals.dtype != torch.float32:
            raise TypeError(f"bell_spmm takes float32 slot values, got {vals.dtype}")
        if vals.shape != bell.flat_vals.shape or not vals.is_contiguous():
            raise ValueError(f"slot values must be a contiguous {tuple(bell.flat_vals.shape)} "
                             f"tensor, got {tuple(vals.shape)}")
        if vals.device != x.device:
            raise ValueError(f"slot values on {vals.device}, features on {x.device}")


def bell_spmm_plain(bell, x: torch.Tensor, n_out_pad: int,
                    vals: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version a CPU tensor runs: bin by bin for a binned layout
    with its own values, slot by slot for every other call."""
    if vals is None and isinstance(bell, BellDev):
        return bell_spmm_reference(bell, x, n_out_pad)
    return bell_spmm_rows_reference(bell, x, n_out_pad, vals)


def vector_width(x: torch.Tensor, width: int | None = None) -> int:
    """The columns a lane keeps of rows of `width` (x's) elements: 16 bytes
    (4 f32 or 8 bf16) where the width is a multiple and x is 16-byte
    aligned; at bf16 4 (8-byte loads) where only 4 divide it and x is
    8-byte aligned; else 1."""
    width = x.shape[1] if width is None else width
    for vec in (16 // x.element_size(), 4):
        if width % vec == 0 and x.data_ptr() % (vec * x.element_size()) == 0:
            return vec
    return 1


def bell_spmm_cuda(bell, x: torch.Tensor, n_out_pad: int,
                   vals: torch.Tensor | None = None, sampled: tuple | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor (arguments as checked by bell_spmm, or
    by bell_spmm_sampled with `sampled` = (DynSlots, k, ra, rb,
    structural): the sampled form); raises when the library cannot be
    built or the launch fails."""
    name, vals_ptr = "bell_spmm", (bell.flat_vals if vals is None else vals).data_ptr()
    dyn_ptrs, dyn_ints = (), ()
    if sampled is not None:
        meta, k, ra, rb, structural = sampled
        name, vals_ptr = "bell_spmm_dyn", bell.flat_vals.data_ptr() if structural else None
        dyn_ptrs, dyn_ints = (meta.deg.data_ptr(), meta.pos.data_ptr()), (k, ra, rb)
    f = x.shape[1]
    units = bell.units
    if units.n_units == 0 or f == 0:
        return torch.zeros((n_out_pad, f), dtype=x.dtype, device=x.device)
    out = torch.empty((n_out_pad, f), dtype=x.dtype, device=x.device)  # padding zeroed by the call
    part = (torch.empty((units.n_partials, f), dtype=torch.float32, device=x.device)
            if units.n_partials else None)
    vec = vector_width(x)
    log2_g = row_lanes(f // vec)
    table, n_warps = units.warps(log2_g)
    ptr = (lambda t: t.data_ptr() if t is not None else None)  # noqa: E731
    launch(build().lib, name, x,
           x.data_ptr(), bell.flat_cols.data_ptr(), vals_ptr, *dyn_ptrs,
           units.start.data_ptr(), units.length.data_ptr(), units.node.data_ptr(),
           units.part.data_ptr(), table, units.split_node.data_ptr(),
           units.split_first.data_ptr(), units.split_count.data_ptr(), ptr(bell.diag),
           out.data_ptr(), ptr(part), n_warps, units.split_node.shape[0], n_out_pad,
           min(units.n_written, n_out_pad), f, vec, log2_g, *dyn_ints)
    return out


def bell_spmm(bell, x: torch.Tensor, n_out_pad: int,
              vals: torch.Tensor | None = None) -> torch.Tensor:
    """out = A @ x on a row-descriptor layout (ops.graph.BellDev or
    SlotRows), A's values the layout's flat_vals or, when given, `vals`
    (one f32 per slot): the kernel on a CUDA tensor, a plain version on a
    CPU tensor.  The result has x's dtype (float32 or bfloat16)."""
    _check(bell, x, n_out_pad, vals)
    if on_card(x, "bell_spmm"):
        return bell_spmm_cuda(bell, x, n_out_pad, vals)
    return bell_spmm_plain(bell, x, n_out_pad, vals)


def dyn_weights_reference(deg: torch.Tensor, pos: torch.Tensor, k: int, ra: int, rb: int,
                          vals: torch.Tensor | None = None) -> torch.Tensor:
    """The sampling weights in plain PyTorch: for slots at in-row
    position `pos` of rows of degree `deg` (ops.graph.DynSlots), the
    count of i < k with (ra*i + rb) mod max(deg, 1) == pos, in f32, 0
    where deg <= 0, times `vals` where given (gala_tpu's
    jnp.where(d > 0, _dyn_counts, 0) * v)."""
    if deg.is_cuda:
        _sampled_counts.reference_calls_on_cuda += 1
    d1, p = deg.long().clamp_min(1), pos.long()
    w = torch.zeros(deg.shape, dtype=torch.float32, device=deg.device)
    for i in range(k):
        w += (torch.remainder(ra * i + rb, d1) == p).float()
    w = torch.where(deg > 0, w, torch.zeros_like(w))
    return w if vals is None else w * vals


def _check_sampling(deg, pos, k, ra, rb, vals) -> None:
    for name, t in (("deg", deg), ("pos", pos)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"dynamic sampling takes contiguous 1-D int32 {name}")
    if pos.shape != deg.shape or pos.device != deg.device:
        raise ValueError(f"pos {tuple(pos.shape)} on {pos.device}, deg {tuple(deg.shape)} "
                         f"on {deg.device}")
    if (vals.dtype != torch.float32 or vals.shape != deg.shape or not vals.is_contiguous()
            or vals.device != deg.device):
        raise ValueError(f"the layout's values must be a contiguous f32 {tuple(deg.shape)} "
                         f"tensor on {deg.device}, one per sampled slot")
    if k < 0 or ra < 0 or rb < 0:
        raise ValueError(f"dynamic sampling takes k, ra, rb >= 0, got {k}, {ra}, {rb}")
    if ra * max(k - 1, 0) + rb > _INT32_MAX:
        raise ValueError(f"ra * (k - 1) + rb = {ra * (k - 1) + rb} overflows int32 "
                         "(gala_tpu samples in int32)")


def bell_spmm_sampled(bell, x: torch.Tensor, n_out_pad: int, meta, k: int, ra: int, rb: int,
                      structural: bool) -> torch.Tensor:
    """out = A_s @ x on a row-descriptor layout, A_s's slot values the
    sampling weights of (k, ra, rb) for the layout's DynSlots `meta`,
    times its flat_vals where `structural`: the kernel's sampled form on
    a CUDA tensor, the plain weights into the row-descriptor plain
    version on a CPU tensor.  Bitwise the SpMM run with
    dyn_weights_reference's weights as `vals`."""
    k, ra, rb = int(k), int(ra), int(rb)
    _check(bell, x, n_out_pad, None)
    _check_sampling(meta.deg, meta.pos, k, ra, rb, bell.flat_vals)
    if on_card(x, "bell_spmm_sampled"):
        return bell_spmm_cuda(bell, x, n_out_pad, sampled=(meta, k, ra, rb, bool(structural)))
    w = dyn_weights_reference(meta.deg, meta.pos, k, ra, rb,
                              bell.flat_vals if structural else None)
    return bell_spmm_rows_reference(bell, x, n_out_pad, w)
