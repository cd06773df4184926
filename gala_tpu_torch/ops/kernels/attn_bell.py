"""Fused slot-space attention: the three hand-written Hopper kernels, their
wrappers and their plain PyTorch versions.

Replaces gala_tpu/ops/pallas/attn_bell.py (attn_fwd_planned,
attn_bwd1_planned, attn_bwd2_planned); the maths is that of
gala_tpu/ops/attention.py (_head_softmax_pos and the hub branch of
_attn_fwd_chunked, _head_bwd_stats, _slot_grads).  The kernels
(`gala_tpu_torch/csrc/attn_bell.cu`) each cover a whole layout in one
call of two launches over the layout's work units (ops.graph.WorkUnits:
units of at most UNIT_SLOTS slots, a hub's units its virtual rows; the
forward and bwd1 over the fwd layout's, bwd2 over the transpose's).  The
second launch merges the split rows' partials: the forward's
unnormalised ones by the online-softmax rescaling, bwd1's plain
[sds | A | B] and bwd2's plain [dx | dvl] sums by addition.  bwd1 runs the
forward's two phases under the rows' saved (m, s): one read of each x[c]
slice sums acc = sum p x and acc+ = sum_{zpre>0} p x, then one dot of
each with dout[r] per unit gives sds and A.
Heads: x is (rows, hf) with head h in columns [h*fh, (h+1)*fh),
fh = hf / H, 1 <= H <= 8.

Row pitch: a kernel lane loads 4 columns of a head (16 bytes at f32, 8
at bf16), or 8 in the bf16 forward where the head holds them (16
bytes).  Where fh is not a multiple of 4, the CUDA wrappers run the
kernels at a padded pitch (`row_pitch`: fh rounded up to a lane, 41 ->
44, or 48 in the bf16 forward): x (and bwd1's dout) with head h at
columns [h*pitch, h*pitch + fh) and zeros after it (`pad_heads`),
launched at hf = H * pitch, the outputs cut back to H * fh columns
(`unpad_heads`).  Scores come from vl and vr, which have no pitch, and
the zero columns add 0 to every sum, so the function is the same.
bwd2's table has one format on both devices: `bwd2_table` writes its
dout block at row_pitch(fh), and the plain bwd2 reads the pitch from the
table's width.  Where fh is a multiple of 4, nothing is copied; every
table a kernel gets is 16-byte aligned, so there is no scalar form.

Shared dout: the gradient of a mean over the H heads gives every head the
same dout (the mean's dout / H).  `bwd2_table` given that one (rows, fh)
block writes it once, [dout at pitch | vr | m | s | sds] (pitch + 4H
floats a row, not H * pitch + 4H), and bwd2 reads it for every head:
the kernel's lanes of each head read the same columns of a row, the plain
versions broadcast it (`shared`).  `per_head_dot` takes it the same way.
The values summed and their order are those of the per-head table that
repeats it, so dx and dvl are bitwise the same.  attn_bwd2 tells the two
forms apart by the table's width, which differs at H > 1.

Heads: the forward and bwd2 have a one-head form and a multi-head form,
chosen by H.  At H > 1 a unit's lanes take its scalar phase across
(slot, head), one coalesced read of a slot's H scores, and the forward's
warp walks its rows' g-vector slices itself.

Layouts are ops.attention.AttnBell's: `flat_vals` holds slot occupancy
(1.0 per real edge, 0.0 on padding slots), used only as a mask.

Element types: x, vl and vr (and bwd1's dout) float32 or bfloat16 (bf16
activations, gala_tpu's dtype=jnp.bfloat16), one instantiation and C
entry point each (gala_attn_*_f32, gala_attn_*_bf16).  Everything else
is f32 at both types, as gala_tpu keeps it: m, s, the outputs, the
partials and merges, bwd2's [dout | vr | m | s | sds] table.  The plain
versions compute in f32 from the same values.

Dispatch (`attn_fwd`, `attn_bwd1` and `attn_bwd2`, the one binding of
each kernel, which for the forward and bwd2 the custom ops
`gala_tpu_torch::attn_fwd` and `::attn_bwd2` of ops.kernels.library run
on either device): a CPU tensor runs the plain version; a CUDA tensor
runs the kernel or raises (no fallback).
`counts_for(name)` records launches and plain-version calls on CUDA
tensors for `attn_fwd`, `attn_bwd1` and `attn_bwd2` (bf16 launches under
`attn_fwd_bf16` and so on, `_build.dtype_counts`).

The plain versions work slot by slot (one entry per slot of the flat
layout, a row's max by scatter_reduce and its sums by index_add_), so
they share nothing with the kernels but the layout.
`attn_fwd_units_reference`, `attn_bwd1_units_reference` and
`attn_bwd2_units_reference` repeat the kernels' two passes in plain
PyTorch (bwd1's with its dot rewrite, bwd2's with its dvl rewrite), for
the tests and the card's checks only.
"""
from __future__ import annotations

import ctypes
import os

import torch

from gala_tpu_torch.ops.kernels._build import (
    CSRC_DIR, DTYPES, Build, build_library, counts_for, launch, on_card, read_limits, wide,
)
from gala_tpu_torch.ops.graph import row_lanes
from gala_tpu_torch.ops.kernels.bell_spmm import unit_slots

_SRC = os.path.join(CSRC_DIR, "attn_bell.cu")
MAX_HEADS = 8
NEG = -1e30  # masked score; a row's max is floored at NEG / 2 (gala_tpu's _NEG)

NAMES = ("attn_fwd", "attn_bwd1", "attn_bwd2")
counts = {name: counts_for(name) for name in NAMES}
# the unit kernels, in the order of gala_attn_{fwd,bwd1,bwd2}_limits
FWD_KERNELS = ("attn_fwd_kernel<4>", "attn_fwd_merge_kernel", "attn_fwd_kernel<4> bf16",
               "attn_fwd_kernel<8> bf16")
BWD1_KERNELS = ("attn_bwd1_kernel<4>", "attn_merge_sum_kernel (bwd1)", "attn_bwd1_kernel<4> bf16")
BWD2_KERNELS = ("attn_bwd2_kernel<4>", "attn_merge_sum_kernel (bwd2)", "attn_bwd2_kernel<4> bf16")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# the library's C functions and their argument types
FUNCTIONS = {
    **{f"gala_attn_fwd_{t}": [_P] * 19 + [_I] * 7 + [_F, _I, _I, _P] for t in DTYPES.values()},
    **{f"gala_attn_bwd1_{t}": [_P] * 18 + [_I] * 6 + [_F, _I, _I, _P] for t in DTYPES.values()},
    **{f"gala_attn_bwd2_{t}": [_P] * 15 + [_I] * 6 + [_F, _I, _I, _I, _P]
       for t in DTYPES.values()},
    "gala_attn_fwd_limits": [_I, _I, _P],
    "gala_attn_bwd1_limits": [_I, _I, _P],
    "gala_attn_bwd2_limits": [_I, _I, _P],
}


def build() -> Build:
    """Compile (once per source version) and load the kernel library.
    Raises when nvcc is missing or the build fails."""
    return build_library(_SRC, "attn_bell", FUNCTIONS)


def launch_limits(nh: int = 1) -> dict:
    """{kernel: registers, static and dynamic shared memory per block,
    resident blocks per SM} of the three kernels' unit kernels at `nh`
    heads, from the CUDA runtime."""
    lib = build().lib
    return {name: read_limits(fn, k, nh)
            for fn, names in ((lib.gala_attn_fwd_limits, FWD_KERNELS),
                              (lib.gala_attn_bwd1_limits, BWD1_KERNELS),
                              (lib.gala_attn_bwd2_limits, BWD2_KERNELS))
            for k, name in enumerate(names)}


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _lrelu(z, slope):
    return torch.where(z > 0, z, slope * z)


def _slot_rows(lay) -> torch.Tensor:
    """(S,) int64: the descriptor row of every slot."""
    n_rows = lay.row_len.shape[0]
    rows = torch.arange(n_rows, device=lay.row_len.device)
    return torch.repeat_interleave(rows, lay.row_len.long(), output_size=lay.flat_cols.shape[0])


def _row_sum(rows, v, n_rows):
    return v.new_zeros((n_rows,) + v.shape[1:]).index_add_(0, rows, v)


def _to_nodes(lay, v, n_pad):
    """Descriptor-row values -> (n_pad, ...) in node order, 0 elsewhere."""
    out = v.new_zeros((n_pad,) + v.shape[1:])
    out[lay.row_node.long()] = v
    return out


def _note_cuda(name, t):
    if t.is_cuda:
        counts[name].reference_calls_on_cuda += 1


def attn_fwd_reference(lay, x, vl, vr, slope: float, n_pad: int, flash: bool):
    """Plain forward on a fwd layout.  Returns (out (n_pad, hf), m, s
    (n_pad, H), outpos (n_pad, hf), spos (n_pad, H)); outpos and spos are
    None unless `flash`.  out is f32 and serves as the flash residual out32.

    Masked slots score NEG; m = max(rowmax, NEG/2); s = 1 where the sum is
    0; a hub's max and sum run over all its virtual rows (one descriptor
    row); padding rows are 0."""
    _note_cuda("attn_fwd", x)
    x, vl, vr = wide(x), wide(vl), wide(vr)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_rows = lay.row_node.shape[0]
    rows = _slot_rows(lay)
    col = lay.flat_cols.long()
    real = (lay.flat_vals != 0)[:, None]
    zpre = vl[col] + vr[lay.row_node.long()[rows]]                # (S, H)
    z = torch.where(real, _lrelu(zpre, slope), NEG)
    m = torch.full((n_rows, nh), NEG, dtype=z.dtype, device=z.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, nh), z, "amax").clamp_min(NEG / 2)
    p = torch.where(real, torch.exp(z - m[rows]), 0.0)
    s = _row_sum(rows, p, n_rows)
    s = torch.where(s > 0, s, 1.0)
    p = p / s[rows]
    xs = x[col].view(-1, nh, fh)
    out = _row_sum(rows, (p[..., None] * xs).view(-1, hf), n_rows)
    outpos = spos = None
    if flash:
        ppos = torch.where(zpre > 0, p, 0.0)
        outpos = _to_nodes(lay, _row_sum(rows, (ppos[..., None] * xs).view(-1, hf), n_rows), n_pad)
        spos = _to_nodes(lay, _row_sum(rows, ppos, n_rows), n_pad)
    return (_to_nodes(lay, out, n_pad), _to_nodes(lay, m, n_pad), _to_nodes(lay, s, n_pad),
            outpos, spos)


def attn_fwd_units_reference(lay, x, vl, vr, slope: float, n_pad: int, flash: bool):
    """The forward kernel's two passes in plain PyTorch (for tests and the
    card's checks), the same function as attn_fwd_reference.  Pass 1, per
    work unit and head: m_u = max(max z, NEG/2), p = e^(z - m_u),
    s_u = sum p, acc_u = sum p x (and s+_u, acc+_u over zpre > 0); a unit
    that is its whole row writes out = acc_u / s_u, m_u, s_u (s = 1 where
    the sum is 0).  Pass 2 merges each split row's partials by gala_tpu's
    online-softmax rescaling: m = max m_u, s = sum s_u e^(m_u - m), the
    same for acc, s+ and acc+."""
    units = lay.units
    x, vl, vr = wide(x), wide(vl), wide(vr)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_u = units.n_units
    unit, slot = unit_slots(units, x.device)
    col = lay.flat_cols.long()[slot]
    real = (lay.flat_vals[slot] != 0)[:, None]
    zpre = vl[col] + vr[units.node.long()[unit]]
    z = torch.where(real, _lrelu(zpre, slope), NEG)
    m_u = torch.full((n_u, nh), NEG / 2, dtype=z.dtype, device=z.device)
    m_u = m_u.scatter_reduce(0, unit[:, None].expand(-1, nh), z, "amax")
    p = torch.where(real, torch.exp(z - m_u[unit]), 0.0)
    ppos = torch.where(zpre > 0, p, 0.0)
    xs = x[col].view(-1, nh, fh)
    stats = [_row_sum(unit, v, n_u) for v in (p, ppos)]
    accs = [_row_sum(unit, (v[..., None] * xs).view(-1, hf), n_u) for v in (p, ppos)]

    out = x.new_zeros((n_pad, hf))
    m, s, spos = (x.new_zeros((n_pad, nh)) for _ in range(3))
    outpos = torch.zeros_like(out)
    whole = units.part < 0
    heads = lambda t: t.repeat_interleave(fh, dim=1)  # noqa: E731

    def write(node, m_r, s_r, sp_r, acc_r, accp_r):
        s_r = torch.where(s_r > 0, s_r, 1.0)
        out[node], m[node], s[node] = acc_r / heads(s_r), m_r, s_r
        outpos[node], spos[node] = accp_r / heads(s_r), sp_r / s_r

    write(units.node[whole].long(), m_u[whole], stats[0][whole], stats[1][whole],
          accs[0][whole], accs[1][whole])
    if units.n_partials:
        idx = units.part[~whole].long()

        def partials(v):  # partial rows in partial order
            return v.new_empty((units.n_partials,) + v.shape[1:]).index_copy_(0, idx, v[~whole])

        pm, ps, psp, pacc, paccp = (partials(v) for v in (m_u, *stats, *accs))
        n_split = units.split_node.shape[0]
        owner = torch.repeat_interleave(torch.arange(n_split, device=x.device),
                                        units.split_count.long())
        mm = torch.full((n_split, nh), NEG / 2, dtype=pm.dtype, device=pm.device)
        mm = mm.scatter_reduce(0, owner[:, None].expand(-1, nh), pm, "amax")
        sc = torch.exp(pm - mm[owner])
        write(units.split_node.long(), mm, _row_sum(owner, ps * sc, n_split),
              _row_sum(owner, psp * sc, n_split), _row_sum(owner, pacc * heads(sc), n_split),
              _row_sum(owner, paccp * heads(sc), n_split))
    return (out, m, s, outpos, spos) if flash else (out, m, s, None, None)


def attn_bwd1_reference(lay, x, vl, vr, dout, m, s, slope: float):
    """Plain backward pass 1 on a fwd layout: p recomputed from the
    node-order (m, s); dp = <dout[r], x[c]> per head; returns
    sds = sum p dp, A = sum p dp lrelu', B = sum p lrelu', each (n_pad, H)."""
    _note_cuda("attn_bwd1", x)
    x, vl, vr, dout = wide(x), wide(vl), wide(vr), wide(dout)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_rows = lay.row_node.shape[0]
    rows = _slot_rows(lay)
    col = lay.flat_cols.long()
    node = lay.row_node.long()[rows]
    real = (lay.flat_vals != 0)[:, None]
    zpre = vl[col] + vr[node]
    p = torch.where(real, torch.exp(_lrelu(zpre, slope) - m[node]) / s[node], 0.0)
    dp = (x[col].view(-1, nh, fh) * dout[node].view(-1, nh, fh)).sum(-1)
    lr = torch.where(zpre > 0, 1.0, slope)
    n_pad = dout.shape[0]
    return tuple(_to_nodes(lay, _row_sum(rows, v, n_rows), n_pad)
                 for v in (p * dp, p * dp * lr, p * lr))


def attn_bwd1_units_reference(lay, x, vl, vr, dout, m, s, slope: float):
    """The bwd1 kernel's two passes in plain PyTorch (for tests and the
    card's checks), the same function as attn_bwd1_reference.  Pass 1, per
    work unit of the fwd layout (destination r) and head, with the row's
    saved (m, s): p = e^(lrelu(zpre) - m_r), lr' = lrelu'(zpre), acc_u =
    sum p x_c and acc'_u = sum p lr' x_c from one read of each x_c, then
    sds_u = <dout_r, acc_u> / s_r, A_u = <dout_r, acc'_u> / s_r and B_u =
    sum p lr' / s_r (the kernel takes acc' as slope acc + (1 - slope) acc+,
    acc+ the sum over zpre > 0: lr' = slope + (1 - slope) [zpre > 0]); a
    unit that is its whole row writes [sds_u | A_u | B_u] to its node, the
    others to their partial rows.  Pass 2 sums each split row's partials
    in unit order.  Returns sds, A, B (n_pad, H)."""
    units = lay.units
    x, vl, vr, dout = wide(x), wide(vl), wide(vr), wide(dout)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_u = units.n_units
    unit, slot = unit_slots(units, x.device)
    node_u = units.node.long()
    node = node_u[unit]
    col = lay.flat_cols.long()[slot]
    real = (lay.flat_vals[slot] != 0)[:, None]
    zpre = vl[col] + vr[node]
    p = torch.where(real, torch.exp(_lrelu(zpre, slope) - m[node]), 0.0)
    pl = p * torch.where(zpre > 0, 1.0, slope)
    xs = x[col].view(-1, nh, fh)
    acc, accl = (_row_sum(unit, (v[..., None] * xs).view(-1, hf), n_u) for v in (p, pl))
    s_u, do = s[node_u], dout[node_u]
    sab = [per_head_dot(do, acc, nh) / s_u, per_head_dot(do, accl, nh) / s_u,
           _row_sum(unit, pl, n_u) / s_u]
    out = _sum_units(units, torch.cat(sab, dim=1), dout.shape[0])
    return out[:, :nh], out[:, nh : 2 * nh], out[:, 2 * nh :]


def attn_bwd2_reference(lay, x, vl, w_tab, slope: float, c_pad: int, shared: bool = False):
    """Plain backward pass 2 on a transpose layout (rows = source nodes c,
    slots = destinations r): w_tab (n_pad, H * pitch + 4H) = [dout | vr |
    m | s | sds] in node order, dout's head h at columns h * pitch, the
    pitch read from the table's width (bwd2_table writes it at
    row_pitch(fh); a table at pitch fh gives the same result); with
    `shared`, (n_pad, pitch + 4H), one dout block that every head takes.
    Returns [dx | dvl] (c_pad, hf + H)."""
    _note_cuda("attn_bwd2", x)
    x, vl = wide(x), wide(vl)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_rows = lay.row_node.shape[0]
    rows = _slot_rows(lay)
    c = lay.row_node.long()[rows]
    w = w_tab[lay.flat_cols.long()]
    real = (lay.flat_vals != 0)[:, None]
    do, vr_g, m_g, s_g, sds_g = _table_blocks(w, nh, fh, shared)
    zpre = vl[c] + vr_g
    p = torch.where(real, torch.exp(_lrelu(zpre, slope) - m_g) / s_g, 0.0)
    dp = (do * x[c].view(-1, nh, fh)).sum(-1)
    dz = p * (dp - sds_g) * torch.where(zpre > 0, 1.0, slope)
    dx = _row_sum(rows, (p[..., None] * do).reshape(-1, hf), n_rows)
    dvl = _row_sum(rows, dz, n_rows)
    return _to_nodes(lay, torch.cat([dx, dvl], dim=1), c_pad)


def attn_bwd2_units_reference(lay, x, vl, w_tab, slope: float, c_pad: int,
                              shared: bool = False):
    """The bwd2 kernel's two passes in plain PyTorch (for tests and the
    card's checks), the same function as attn_bwd2_reference.  Pass 1, per
    work unit of the transpose layout (source c) and head, from one read of
    each destination row: p = e^(lrelu(zpre) - m_r) / s_r, lr' =
    lrelu'(zpre), dx_u = sum p dout_r, q_u = sum p lr' dout_r and
    dvl_u = <q_u, x[c]> - sum p lr' sds_r; a unit that is its whole row
    writes [dx_u | dvl_u] to its node, the others to their partial rows.
    Pass 2 sums each split row's partials in unit order.  `shared` as
    attn_bwd2_reference's."""
    units = lay.units
    x, vl = wide(x), wide(vl)
    hf, nh = x.shape[1], vl.shape[1]
    fh = hf // nh
    n_u = units.n_units
    unit, slot = unit_slots(units, x.device)
    c = units.node.long()[unit]
    w = w_tab[lay.flat_cols.long()[slot]]
    real = (lay.flat_vals[slot] != 0)[:, None]
    do, vr_g, m_g, s_g, sds_g = _table_blocks(w, nh, fh, shared)
    zpre = vl[c] + vr_g
    p = torch.where(real, torch.exp(_lrelu(zpre, slope) - m_g) / s_g, 0.0)
    pl = p * torch.where(zpre > 0, 1.0, slope)
    dx = _row_sum(unit, (p[..., None] * do).reshape(-1, hf), n_u)
    q = _row_sum(unit, (pl[..., None] * do).reshape(-1, hf), n_u)
    dvl = per_head_dot(q, x[units.node.long()], nh) - _row_sum(unit, pl * sds_g, n_u)
    return _sum_units(units, torch.cat([dx, dvl], dim=1), c_pad)


def _table_blocks(w, nh: int, fh: int, shared: bool = False) -> tuple:
    """Rows w of bwd2's table, at the pitch its width gives: dout (rows, H,
    fh; with `shared` its one block broadcast to every head), then vr, m,
    s and sds (rows, H)."""
    d = w.shape[1] - 4 * nh
    if shared:
        do = w[:, :d].view(-1, 1, d)[..., :fh].expand(-1, nh, fh)
    else:
        do = w[:, :d].view(-1, nh, d // nh)[..., :fh]
    return (do, *(w[:, d + i * nh : d + (i + 1) * nh] for i in range(4)))


def _sum_units(units, acc, n_out):
    """Pass 2 of bwd1 and bwd2: each unit's row of `acc` goes to its node
    where the unit is its whole row, else to its partial row, and each
    split row's partials are summed in unit order.  (n_out, width), 0 on
    rows that no unit writes."""
    out = acc.new_zeros((n_out, acc.shape[1]))
    whole = units.part < 0
    out[units.node[whole].long()] = acc[whole]
    if units.n_partials:
        part = acc.new_empty((units.n_partials, acc.shape[1]))
        part[units.part[~whole].long()] = acc[~whole]
        n_split = units.split_node.shape[0]
        owner = torch.repeat_interleave(torch.arange(n_split, device=acc.device),
                                        units.split_count.long())
        out[units.split_node.long()] = _row_sum(owner, part, n_split)
    return out


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #
def _check(lay, x, vl, tables: dict, n_out: int, f32: tuple = ()) -> None:
    """dtype, shape and device checks shared by the wrappers; `tables`
    names the other tensor arguments.  x is float32 or bfloat16; vl and
    the tables take x's dtype, except those named in `f32`."""
    nh = vl.shape[1] if vl.dim() == 2 else 0
    if x.dtype not in DTYPES:
        raise TypeError(f"attention kernels take float32 or bfloat16 x, got {x.dtype}")
    for name, t in {"x": x, "vl": vl, **tables}.items():
        want = torch.float32 if name in f32 else x.dtype
        if t.dtype != want:
            raise TypeError(f"attention kernels take {name} in {want} with x in {x.dtype}, "
                            f"got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.device != lay.flat_cols.device:
            raise ValueError(f"layout on {lay.flat_cols.device}, {name} on {t.device}")
    if not 1 <= nh <= MAX_HEADS or x.shape[1] % nh:
        raise ValueError(f"{nh} heads of {x.shape[1]} features: need 1 <= H <= "
                         f"{MAX_HEADS} dividing the width")
    if vl.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and vl {tuple(vl.shape)} must share rows")
    if n_out < lay.n_real:
        raise ValueError(f"{n_out} output rows < {lay.n_real} real rows")
    if lay.units.start.dtype != torch.int64:
        raise TypeError(f"work-unit starts must be int64, got {lay.units.start.dtype}")


def _unit_args(u, hf: int, vec: int) -> tuple[int, tuple]:
    """(log2_g, a WorkUnits' tables in the kernels' argument order): the
    unit tables, the warp table of g = 2^log2_g lanes across a row of hf /
    vec vectors (ops.graph.row_lanes; None at 32 lanes), the split
    tables."""
    log2_g = row_lanes(hf // vec)
    table, _ = u.warps(log2_g)
    return log2_g, (u.start.data_ptr(), u.length.data_ptr(), u.node.data_ptr(),
                    u.part.data_ptr(), table, u.split_node.data_ptr(),
                    u.split_first.data_ptr(), u.split_count.data_ptr())


def _unit_ints(u, log2_g: int, n_out: int) -> tuple:
    """(warps, split rows, output rows, the first output row to zero) of a
    call with 2^log2_g lanes across a row."""
    return u.warps(log2_g)[1], u.split_node.shape[0], n_out, min(u.n_written, n_out)


def _ptr(t):
    return t.data_ptr() if t is not None else None


# --------------------------------------------------------------------------- #
# row pitch
# --------------------------------------------------------------------------- #
def row_pitch(fh: int, lane: int = 4) -> int:
    """The columns a head of fh takes in the kernels' feature tables: fh
    where it is a multiple of 4, which every kernel's lanes take as it is;
    else fh rounded up to `lane` columns, one lane's load (4; 8 in the
    bf16 forward, which loads 16 bytes a lane)."""
    return fh if fh % 4 == 0 else -(-fh // lane) * lane


def head_blocks(t: torch.Tensor, nh: int, pitch: int) -> list[torch.Tensor]:
    """t (rows, nh * fh) as the column blocks of its pitched form, for one
    torch.cat: each head's fh columns, then pitch - fh zero columns; [t]
    where pitch == fh."""
    rows, fh = t.shape[0], t.shape[1] // nh
    if pitch == fh:
        return [t]
    zeros = t.new_zeros((rows, pitch - fh))
    return [b for h in range(nh) for b in (t[:, h * fh : (h + 1) * fh], zeros)]


def pad_heads(t: torch.Tensor, nh: int, pitch: int) -> torch.Tensor:
    """(rows, nh * pitch): head h of t (rows, nh * fh) at columns
    [h * pitch, h * pitch + fh), zeros after it; t itself where
    pitch == fh."""
    blocks = head_blocks(t, nh, pitch)
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def unpad_heads(t: torch.Tensor, nh: int, fh: int, pitch: int) -> torch.Tensor:
    """t (rows, nh * pitch + tail) cut back to (rows, nh * fh + tail):
    head h's first fh columns, then the `tail` columns after the heads
    (bwd2's dvl).  t itself where pitch == fh; a view at one head with no
    tail; else a copy."""
    if pitch == fh:
        return t
    if nh == 1 and t.shape[1] == pitch:
        return t[:, :fh]
    return torch.cat([t[:, h * pitch : h * pitch + fh] for h in range(nh)]
                     + [t[:, nh * pitch :]], dim=1)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t 16-byte aligned, as the kernels' lanes load it: t itself, or a
    copy of a misaligned view."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bwd2_table(x, dout, vr, m, s, sds) -> torch.Tensor:
    """bwd2's w_tab [dout | vr | m | s | sds] (rows, H * pitch + 4H), f32,
    for x of H = vr.shape[1] heads, in one torch.cat: dout's head h at
    columns [h * pitch, h * pitch + fh), zeros after it, pitch the
    kernel's row_pitch(fh) on either device.  Where dout is one (rows,
    fh) block that every head takes (the gradient of a mean over the
    heads), the shared form (rows, pitch + 4H): that block once, at the
    pitch.  attn_bwd2 takes only these tables."""
    fh = x.shape[1] // vr.shape[1]
    return torch.cat([*head_blocks(wide(dout), dout.shape[1] // fh, row_pitch(fh)), wide(vr),
                      m, s, sds], dim=1)


def _check_fwd(lay, x, vl, vr, n_pad: int) -> None:
    _check(lay, x, vl, {"vr": vr}, n_pad)
    if x.shape[0] < lay.n_src or vr.shape != (n_pad, vl.shape[1]):
        raise ValueError(f"x needs >= {lay.n_src} rows (has {x.shape[0]}) and vr "
                         f"({n_pad}, {vl.shape[1]}) (is {tuple(vr.shape)})")


def attn_fwd(lay, x, vl, vr, slope: float, n_pad: int, flash: bool):
    """Attention forward on a fwd layout (see attn_fwd_reference): the
    kernel on CUDA tensors, the plain version on CPU tensors.  x, vl and
    vr share one dtype; every output is f32."""
    _check_fwd(lay, x, vl, vr, n_pad)
    if on_card(x, "attn_fwd"):
        return attn_fwd_cuda(lay, x, vl, vr, slope, n_pad, flash)
    return attn_fwd_reference(lay, x, vl, vr, slope, n_pad, flash)


def attn_fwd_cuda(lay, x, vl, vr, slope: float, n_pad: int, flash: bool):
    """The forward kernel on CUDA tensors (arguments as checked by attn_fwd),
    at x's row pitch for lanes of 16 bytes; out and outpos come back as
    H * fh columns."""
    nh, lane = vl.shape[1], 16 // x.element_size()
    fh = x.shape[1] // nh
    pitch = row_pitch(fh, lane)
    x = _aligned(pad_heads(x, nh, pitch))
    hf = x.shape[1]
    # padding rows zeroed by the call (rows no unit writes stay 0)
    out = torch.empty((n_pad, hf), dtype=torch.float32, device=x.device)
    m = torch.empty((n_pad, nh), dtype=torch.float32, device=x.device)
    s = torch.empty_like(m)
    outpos = torch.empty_like(out) if flash else None
    spos = torch.empty_like(m) if flash else None
    u = lay.units
    # the split rows' partials: acc, acc+ (P, hf) then m, s, s+ (P, H)
    part = (torch.empty((u.n_partials * (2 * hf + 3 * nh),), dtype=torch.float32,
                        device=x.device) if u.n_partials else None)
    # a lane's columns: 16 bytes of x where each head holds them, else 8
    # (bf16 heads of 4k columns); the outputs are f32, 16 or 32 bytes a lane
    vec = lane if pitch % lane == 0 else 4
    log2_g, tables = _unit_args(u, hf, vec)
    n_warps, n_split, _, zero_from = _unit_ints(u, log2_g, n_pad)
    launch(build().lib, "attn_fwd", x,
           x.data_ptr(), vl.data_ptr(), vr.data_ptr(), lay.flat_cols.data_ptr(),
           lay.flat_vals.data_ptr(), *tables,
           out.data_ptr(), m.data_ptr(), s.data_ptr(), _ptr(outpos), _ptr(spos), _ptr(part),
           n_warps, n_split, u.n_partials, n_pad, zero_from, hf, nh, float(slope), vec, log2_g)
    if flash:
        outpos = unpad_heads(outpos, nh, fh, pitch)
    return unpad_heads(out, nh, fh, pitch), m, s, outpos, spos


def attn_bwd1(lay, x, vl, vr, dout, m, s, slope: float):
    """Backward pass 1 on a fwd layout (see attn_bwd1_reference): sds, A,
    B (n_pad, H), f32; on CUDA tensors three column views of one (n_pad,
    3H) table.  x, vl, vr and dout share one dtype; m and s are f32."""
    n_pad = dout.shape[0]
    _check(lay, x, vl, {"vr": vr, "dout": dout, "m": m, "s": s}, n_pad, f32=("m", "s"))
    nh = vl.shape[1]
    if (x.shape[0] < lay.n_src or dout.shape[1] != x.shape[1]
            or any(t.shape != (n_pad, nh) for t in (vr, m, s))):
        raise ValueError(f"x needs >= {lay.n_src} rows, dout (n_pad, hf) and vr, m, s "
                         "(n_pad, H)")
    if on_card(x, "attn_bwd1"):
        return attn_bwd1_cuda(lay, x, vl, vr, dout, m, s, slope)
    return attn_bwd1_reference(lay, x, vl, vr, dout, m, s, slope)


def attn_bwd1_cuda(lay, x, vl, vr, dout, m, s, slope: float):
    """The bwd1 kernel on CUDA tensors (arguments as checked by attn_bwd1),
    x and dout at x's row pitch for lanes of 4 columns."""
    nh, n_pad = vl.shape[1], dout.shape[0]
    pitch = row_pitch(x.shape[1] // nh)
    x, dout = _aligned(pad_heads(x, nh, pitch)), _aligned(pad_heads(dout, nh, pitch))
    hf = x.shape[1]
    # padding rows zeroed by the call (rows no unit writes stay 0)
    out = torch.empty((n_pad, 3 * nh), dtype=torch.float32, device=x.device)
    u = lay.units
    # the split rows' partial [sds | A | B] rows
    part = (torch.empty((u.n_partials * 3 * nh,), dtype=torch.float32, device=x.device)
            if u.n_partials else None)
    log2_g, tables = _unit_args(u, hf, 4)
    launch(build().lib, "attn_bwd1", x,
           x.data_ptr(), vl.data_ptr(), vr.data_ptr(), dout.data_ptr(), m.data_ptr(),
           s.data_ptr(), lay.flat_cols.data_ptr(), lay.flat_vals.data_ptr(), *tables,
           out.data_ptr(), _ptr(part), *_unit_ints(u, log2_g, n_pad), hf, nh, float(slope),
           4, log2_g)
    return out[:, :nh], out[:, nh : 2 * nh], out[:, 2 * nh :]


def shared_table(x, vl, w_tab) -> bool:
    """Whether bwd2's table, as bwd2_table builds it for x of H = vl's
    heads, is the shared form: one dout block at the pitch, not H (the
    widths differ at H > 1)."""
    nh = vl.shape[1]
    return nh > 1 and w_tab.shape[1] == row_pitch(x.shape[1] // nh) + 4 * nh


def _check_bwd2(lay, x, vl, w_tab, c_pad: int) -> None:
    _check(lay, x, vl, {"w_tab": w_tab}, c_pad, f32=("w_tab",))
    nh = vl.shape[1]
    pitch = row_pitch(x.shape[1] // nh)
    widths = {nh * pitch + 4 * nh, pitch + 4 * nh}
    if w_tab.shape[1] not in widths or w_tab.shape[0] < lay.n_src:
        raise ValueError(f"w_tab {tuple(w_tab.shape)} must be (>= {lay.n_src}, one of "
                         f"{sorted(widths)}), as bwd2_table builds it")
    if x.shape[0] < lay.n_real:
        raise ValueError(f"x has {x.shape[0]} rows, the layout has {lay.n_real} source rows")


def attn_bwd2(lay, x, vl, w_tab, slope: float, c_pad: int):
    """Backward pass 2 on a transpose layout (see attn_bwd2_reference):
    returns [dx | dvl] (c_pad, hf + H), f32.  x and vl share one dtype;
    w_tab is f32, built by bwd2_table, per head or shared (told apart by
    its width)."""
    _check_bwd2(lay, x, vl, w_tab, c_pad)
    run = attn_bwd2_cuda if on_card(x, "attn_bwd2") else attn_bwd2_reference
    return run(lay, x, vl, w_tab, slope, c_pad, shared_table(x, vl, w_tab))


def attn_bwd2_cuda(lay, x, vl, w_tab, slope: float, c_pad: int, shared: bool = False):
    """The bwd2 kernel on CUDA tensors (arguments as checked by attn_bwd2),
    x at its row pitch for lanes of 4 columns, as w_tab's dout block
    (bwd2_table; its width, H * pitch or with `shared` the one block's
    pitch, goes to the kernel); [dx | dvl] comes back as H * fh + H
    columns."""
    nh = vl.shape[1]
    fh = x.shape[1] // nh
    pitch = row_pitch(fh)
    dout_w = pitch if shared else nh * pitch
    x, w_tab = _aligned(pad_heads(x, nh, pitch)), _aligned(w_tab)
    hf = x.shape[1]
    # padding rows zeroed by the call (rows no unit writes stay 0)
    out = torch.empty((c_pad, hf + nh), dtype=torch.float32, device=x.device)
    u = lay.units
    # the split rows' partial [dx | dvl] rows
    part = (torch.empty((u.n_partials * (hf + nh),), dtype=torch.float32, device=x.device)
            if u.n_partials else None)
    log2_g, tables = _unit_args(u, hf, 4)
    launch(build().lib, "attn_bwd2", x,
           w_tab.data_ptr(), x.data_ptr(), vl.data_ptr(), lay.flat_cols.data_ptr(),
           lay.flat_vals.data_ptr(), *tables, out.data_ptr(), _ptr(part),
           *_unit_ints(u, log2_g, c_pad), hf, nh, float(slope), 4, log2_g, dout_w)
    del x, w_tab, part  # pitched copies and scratch freed before the cut-back copy
    return unpad_heads(out, nh, fh, pitch)


# --------------------------------------------------------------------------- #
# kernels against plain versions (for the card's checks)
# --------------------------------------------------------------------------- #
def per_head_dot(a: torch.Tensor, b: torch.Tensor, nh: int) -> torch.Tensor:
    """(rows, H): <a, b> over each head's fh columns; a (rows, fh) is
    every head's (a shared dout), the same products and sums as a
    repeated H times."""
    if a.shape[1] != b.shape[1]:
        return (a[:, None, :] * b.view(b.shape[0], nh, -1)).sum(-1)
    return (a * b).view(a.shape[0], nh, -1).sum(-1)


def compare_with_plain(ab, x, vl, vr, dout, slope: float, n_pad: int, c_pad: int) -> dict:
    """Run the three kernels and their plain versions on one AttnBell at
    the same CUDA inputs; returns {check: (max |kernel - plain|, elements
    out of tolerance)}.

    Tolerance per element, in f32: |kernel - plain| <= 1e-4 + 1e-4 * scale,
    where scale is the sum of the magnitudes of the terms (the plain
    version run on absolute values: P |x| for out, sum p |<dout, x>| for
    sds and A, sum p |dout| for dx, sum p (|dp| + |sds|) for dvl; the
    value itself where all terms are positive: s, s+, B).  The two sum in
    different orders, the kernel with an online softmax, and a sum's
    rounding error grows with its terms, not with its result.  m takes no
    sum and is held to 1e-4.  bwd1 is also held to the flash identity:
    sds = <dout, out> and A - sds B = (1 - slope)(<dout, out+> - sds s+)."""
    nh = vl.shape[1]
    res = {}

    def check(name, got, want, scale):
        err = (got - want).abs()
        res[name] = (err.max().item() if err.numel() else 0.0,
                     int((err > 1e-4 + 1e-4 * scale).sum()))

    out, m, s, outpos, spos = attn_fwd(ab.fwd, x, vl, vr, slope, n_pad, True)
    r_out, r_m, r_s, r_outpos, r_spos = attn_fwd_reference(ab.fwd, x, vl, vr, slope, n_pad, True)
    a_out, _, _, a_outpos, _ = attn_fwd_reference(ab.fwd, x.abs(), vl, vr, slope, n_pad, True)
    check("fwd out", out, r_out, a_out)
    check("fwd m", m, r_m, 0.0)
    check("fwd s", s, r_s, r_s)
    check("fwd out+", outpos, r_outpos, a_outpos)
    check("fwd s+", spos, r_spos, r_spos)

    sds, a, b = attn_bwd1(ab.fwd, x, vl, vr, dout, r_m, r_s, slope)
    r_sds, r_a, r_b = attn_bwd1_reference(ab.fwd, x, vl, vr, dout, r_m, r_s, slope)
    a_sds, _, _ = attn_bwd1_reference(ab.fwd, x.abs(), vl, vr, dout.abs(), r_m, r_s, slope)
    check("bwd1 sds", sds, r_sds, a_sds)
    check("bwd1 A", a, r_a, a_sds)
    check("bwd1 B", b, r_b, r_b)
    check("bwd1 sds = <dout, out>", sds, per_head_dot(dout, out, nh), a_sds)
    check("bwd1 A - sds B = flash identity", a - sds * b,
          (1.0 - slope) * (per_head_dot(dout, outpos, nh) - sds * spos), 2 * a_sds)

    w_tab = bwd2_table(x, dout, vr, r_m, r_s, r_sds)
    dxx = attn_bwd2(ab.t, x, vl, w_tab, slope, c_pad)
    r_dxx = attn_bwd2_reference(ab.t, x, vl, w_tab, slope, c_pad)
    a_tab = bwd2_table(x, dout.abs(), vr, r_m, r_s, -r_sds.abs())
    a_dxx = attn_bwd2_reference(ab.t, x.abs(), vl, a_tab, slope, c_pad)
    hf = x.shape[1]
    check("bwd2 dx", dxx[:, :hf], r_dxx[:, :hf], a_dxx[:, :hf])
    check("bwd2 dvl", dxx[:, hf:], r_dxx[:, hf:], a_dxx[:, hf:])
    return res


def aggregate_scales(ab, x, vl, vr, dout, slope: float, n_pad: int, c_pad: int):
    """Magnitudes of the summed terms of attention_aggregate's out, dx, dvl
    and dvr (the gradients of sum(out * dout)), from the plain versions on
    absolute values, as compare_with_plain takes them: a result is held
    to 1e-4 + 1e-4 * its scale."""
    hf, nh = x.shape[1], vl.shape[1]
    _, m, s, _, spos = attn_fwd_reference(ab.fwd, x, vl, vr, slope, n_pad, True)
    a_out, _, _, a_outpos, _ = attn_fwd_reference(ab.fwd, x.abs(), vl, vr, slope, n_pad, True)
    a_sds = per_head_dot(dout.abs().float(), a_out, nh)
    a_tab = bwd2_table(x, dout.abs(), vr, m, s, -a_sds)
    a_dxx = attn_bwd2_reference(ab.t, x.abs(), vl, a_tab, slope, c_pad)
    a_dvr = (1.0 - slope) * (per_head_dot(dout.abs(), a_outpos, nh) + a_sds * spos)
    return a_out, a_dxx[:, :hf], a_dxx[:, hf:], a_dvr
