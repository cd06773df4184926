"""Device-side graph container (the port of gala_tpu.ops.graph).

A `Graph` holds one graph's aggregation layout as torch tensors on one
device, for the strategies this port executes:

    'dense'   the adjacency densified once; SpMM = `a_dense @ x`.
    'bell'    binned ELL (gala_tpu_torch.data.ell.build_binned_ell): every
              node owns one row of its degree class's width, hubs own
              ceil(deg/128) contiguous virtual rows.  Forward runs on
              `bell`, the backward on the transpose layout `t_bell`
              (aliased when A == A^T by value).
    'ell'     row-split ELL (data.ell.build_ell) and its transpose, whose
              slots map to forward edge ids (`perm`): learned edge values
              permute straight into either layout.  gala_tpu's pick for
              graphs with edge values above the dense gate.
    'segment' the dst-sorted, padded edge list, one slot per edge.
    'segment_scan'  the same executor: gala_tpu's lax.scan chunking is a
              TPU memory device that does not carry over.

Every sparse layout is described by per-row descriptors (`row_start`,
`row_len`, `row_node` over `flat_cols`/`flat_vals`), and the kernels run
over the layout's work units (`WorkUnits`, cut from the descriptors
once on the host: no unit holds more than UNIT_SLOTS slots), so one SpMM
kernel executes all of them.  Row and unit starts are int64, so a layout
may hold more than 2^31 slots.

Column tiling (the DSL's `G=G.col_tile(T);`, `col_tile=T`): on every
row-descriptor layout each row's slots are grouped by column tile
(columns [t*T, (t+1)*T), in their own order within a tile), every unit
lies in one tile, and units run tile-major (`work_unit_tables`).  Each
layout's constructor computes the slot permutation once (`tile_order`)
and keeps it as its `slot_order`, which the sampling inputs follow.  The
slots' values, edge ids and sampling inputs move with them, so results
are those of the untiled layout up to the order of the sums.  'dense'
ignores the directive, as in gala_tpu.

Edge ids (`perm` of the ELL and tiled edge-list layouts, `t_perm`,
`row_ptr`, `t_row_ptr`) are int64 with long_indices=True or past 2^31
padded edges, int32 otherwise, as in gala_tpu; node ids stay int32.

Edge lists (`src`, `dst`, `vals`, `t_*`, `t_perm`) are kept where gala_tpu
keeps them by default (with edge values, or off 'bell'), padded
to e_pad = round_up(E+1, 128) edges with dst = the phantom row, src 0
and value 0.  Node dimensions are padded as in gala_tpu (n_pad =
round_up(n+1, 8): at least one phantom row, which absorbs padding
slots).  'pallas_bell' is 'bell', as in gala_tpu, where it names the
bell layout run by its Pallas kernels: here the hand kernels are the
bell layout's only executor.  With attention=True a 'bell' graph also
carries the fused-attention layout (`attn`, ops.attention.AttnBell);
other strategies build none and run the unfused chain, as gala_tpu does.

With dynamic_sample=True (gala_tpu's DynMeta) a graph also carries the
per-slot sampling inputs of the layout that ops.spmm.spmm_sampled runs
(`dyn_f`, `dyn_t`: DynSlots): on 'bell' of `bell`/`t_bell`, built with
the self loops as slots (split_diag=False, so a slot's position in its
row is its CSR position); on every other strategy of the edge-list
layouts `seg`/`t_seg`.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from gala_tpu_torch.data.csr import HostCSR, densify, is_symmetric
from gala_tpu_torch.data.csr import transpose as host_transpose
from gala_tpu_torch.utils.profiling import marker

if TYPE_CHECKING:
    from gala_tpu_torch.ops.attention import AttnBell

EDGE_PAD = 128
NODE_PAD = 8
_DENSE_MAX_NODES = 16384  # N_pad^2 f32 <= 1GB (gala_tpu's gate, unchanged)
_STRATEGIES = ("dense", "bell", "ell", "segment", "segment_scan")
_INT32_MAX = 2**31 - 1
# L, the most slots of one work unit: kUnitSlots in csrc/unit_gather.cuh.
# Equal to data.ell.K_BIG, so a hub's units are its virtual rows.
UNIT_SLOTS = 128
# A unit's level l is the largest l < UNIT_LEVELS with length <= UNIT_SLOTS
# >> l; a warp takes min(2^l, 32 / g) units of one level (kLevels in
# csrc/unit_gather.cuh), g = 2^log2_g lanes across a row.  Tables are kept
# for log2_g < PACKED_LANES; at g = 32 a warp takes one unit.
UNIT_LEVELS = 6
PACKED_LANES = 5


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def moved(obj, device, memo: dict | None = None):
    """`obj` (a tensor, a layout dataclass of this module, or a tuple or
    list of them) with every tensor on `device`.  Each object is moved
    once (`memo`, by identity), so what two fields share stays shared:
    t_bell aliasing bell, the one Graph of every layer."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, (tuple, list)):
        out = type(obj)(moved(v, device, memo) for v in obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = obj.to(device, memo)
    else:
        return obj
    memo[id(obj)] = out
    return out


def _moved_fields(obj, to, memo, **fixed):
    """dataclasses.replace of `obj` with every field moved to `to`, but `fixed`."""
    return dataclasses.replace(obj, **{f.name: moved(getattr(obj, f.name), to, memo)
                                       for f in dataclasses.fields(obj) if f.name not in fixed},
                               **fixed)


def bin_views(flat_vals: torch.Tensor, bin_ks, bin_counts, n_big: int, big_k: int):
    """(bin_vals, big_vals) of a binned layout: each bin's (n_b, k_b) view
    of flat_vals, then the hubs' (Vb, big_k) view (None without hubs)."""
    views, off = [], 0
    for k, nb in zip(bin_ks, bin_counts):
        views.append(flat_vals[off : off + nb * k].view(nb, k))
        off += nb * k
    return tuple(views), flat_vals[off:].view(-1, big_k) if n_big else None


@dataclasses.dataclass
class WorkUnits:
    """The kernels' work over a row-descriptor layout, cut once on the host.

    Unit u reads slots [start[u], start[u] + length[u]) of the row of
    node[u]; length[u] <= UNIT_SLOTS.  A row of at most UNIT_SLOTS slots
    is one unit with part[u] = -1: it writes its node's output row (and,
    on a layout with a diagonal, the diag*x term).  A longer row is cut
    into ceil(len / UNIT_SLOTS) units, each writing its partial to row
    part[u] of a scratch table; one split row's partials are contiguous
    and in slot order, and split row r (node split_node[r]) owns partials
    [split_first[r], split_first[r] + split_count[r]), which the merge
    sums in that order.  A row of no slots keeps one unit of length 0:
    its node still gets its epilogue.  Units are ordered longest first
    (stably), so no long unit starts last; with column tiling (see
    work_unit_tables) a row is first cut at its column-tile boundaries and
    units run tile-major, longest first within a tile.

    The SpMM and the attention forward give a warp several short units
    (warp_tables): for g = 2^log2_g lanes across a row (log2_g <
    PACKED_LANES), warp w takes units [t[w], t[w + 1]) of the table t =
    warp_first[warp_off[log2_g] : warp_off[log2_g + 1]], at most 32 / g of
    them, all of one level and one column tile; at g = 32 warp w takes
    unit w.  The tables are host work: a call reads its warp count here,
    without a device sync (`warps`).  Every output row below n_written
    is some row's node, so a call zeroes only the rows from n_written on
    (padding)."""

    start: torch.Tensor          # (U,) int64 first slot of unit u
    length: torch.Tensor         # (U,) int32 slots of unit u
    node: torch.Tensor           # (U,) int32 global row of unit u's row
    part: torch.Tensor           # (U,) int32 partial row of unit u, -1: writes its node
    split_node: torch.Tensor     # (R_split,) int32 node of split row r
    split_first: torch.Tensor    # (R_split,) int32 its first partial
    split_count: torch.Tensor    # (R_split,) int32 its partials
    warp_first: torch.Tensor     # int32 the warp tables, one per log2_g < PACKED_LANES
    n_units: int
    n_partials: int
    warp_off: tuple              # PACKED_LANES + 1 ints: where each table starts, then the end
    n_written: int               # the smallest output row that no row's node is

    @classmethod
    def from_rows(cls, row_start, row_len, row_node, device, cols=None,
                  col_tile: int = 0) -> "WorkUnits":
        t = work_unit_tables(row_start, row_len, row_node, cols, col_tile)
        off = tuple(int(v) for v in t.pop("warp_off"))
        n_written = int(t.pop("n_written"))
        return cls(**{k: _put(v, device) for k, v in t.items()},
                   n_units=t["start"].shape[0], n_partials=int(t["split_count"].sum()),
                   warp_off=off, n_written=n_written)

    def warps(self, log2_g: int) -> tuple[int | None, int]:
        """(the address of the warp table, warps) of a call with 2^log2_g
        lanes across a row; (None, n_units) at 32 lanes, one unit a warp."""
        if log2_g >= PACKED_LANES:
            return None, self.n_units
        lo, hi = self.warp_off[log2_g], self.warp_off[log2_g + 1]
        return self.warp_first.data_ptr() + lo * self.warp_first.element_size(), hi - lo - 1

    def to(self, device, memo: dict | None = None) -> "WorkUnits":
        return _moved_fields(self, device, {} if memo is None else memo)


def _row_slots(row_start, row_len):
    """(descriptor row of each described slot, the slot), row by row."""
    row = np.repeat(np.arange(row_len.shape[0]), row_len)
    first = np.cumsum(row_len) - row_len
    return row, row_start[row] + np.arange(row.shape[0]) - first[row]


def _pieces(row_start, row_len, cols, col_tile: int):
    """Each row cut where its slots' column tile (col // col_tile)
    changes: (row, first slot, slots, tile) of every piece, row by row
    and in slot order within a row.  Without col_tile a row is one piece
    of tile 0; a row of no slots is one empty piece."""
    n_rows = row_len.shape[0]
    if not col_tile:
        return np.arange(n_rows), row_start, row_len, np.zeros(n_rows, np.int64)
    row, slot = _row_slots(row_start, row_len)
    tile = np.asarray(cols)[slot].astype(np.int64) // col_tile
    head = np.ones(slot.shape[0], bool)
    head[1:] = (row[1:] != row[:-1]) | (tile[1:] != tile[:-1])
    head = np.flatnonzero(head)
    empty = np.flatnonzero(row_len == 0)
    p_row = np.concatenate([row[head], empty])
    p_len = np.concatenate([np.diff(np.append(head, slot.shape[0])), np.zeros_like(empty)])
    p_start = np.concatenate([slot[head], row_start[empty]])
    p_tile = np.concatenate([tile[head], np.zeros_like(empty)])
    by_row = np.argsort(p_row, kind="stable")
    return p_row[by_row], p_start[by_row], p_len[by_row], p_tile[by_row]


def work_unit_tables(row_start, row_len, row_node, cols=None, col_tile: int = 0) -> dict:
    """WorkUnits' tables as numpy arrays (start int64, the rest int32)
    and n_written, from host descriptors.  With col_tile T > 0, `cols` the layout's
    flat columns: a row is first cut into pieces at its column-tile
    boundaries (tile = col // T), each piece into units of at most
    UNIT_SLOTS slots, so every unit lies in one tile; a row of more than
    one unit is split, its partials in slot order as without tiles; and
    units run tile-major, longest first within a tile."""
    row_start, row_len = np.asarray(row_start, np.int64), np.asarray(row_len, np.int64)
    row_node = np.asarray(row_node, np.int64)
    p_row, p_start, p_len, p_tile = _pieces(row_start, row_len, cols, int(col_tile or 0))
    n_u = np.maximum(-(-p_len // UNIT_SLOTS), 1)
    piece = np.repeat(np.arange(p_len.shape[0]), n_u)
    k = np.arange(piece.shape[0]) - np.repeat(np.cumsum(n_u) - n_u, n_u)
    start = p_start[piece] + k * UNIT_SLOTS
    length = np.minimum(p_len[piece] - k * UNIT_SLOTS, UNIT_SLOTS)
    row = p_row[piece]
    per_row = np.bincount(row, minlength=row_len.shape[0])
    split = per_row > 1
    in_split = split[row]
    part = np.full(row.shape[0], -1, np.int64)
    part[in_split] = np.arange(int(in_split.sum()))
    count = per_row[split]
    order = np.argsort(-length, kind="stable")
    if col_tile:
        order = order[np.argsort(p_tile[piece][order], kind="stable")]
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    warp_first, warp_off = warp_tables(length[order], p_tile[piece][order])
    nodes = np.unique(row_node)
    gap = np.flatnonzero(nodes != np.arange(nodes.shape[0]))
    return dict(n_written=np.int32(gap[0] if gap.shape[0] else nodes.shape[0]),
                start=start[order], length=i32(length[order]),
                node=i32(row_node[row][order]), part=i32(part[order]),
                split_node=i32(row_node[split]), split_first=i32(np.cumsum(count) - count),
                split_count=i32(count), warp_first=warp_first, warp_off=warp_off)


def row_lanes(vectors: int) -> int:
    """log2 of the lanes across a row of `vectors` vectors (the smallest
    power of two that covers them, at most 32): csrc/unit_gather.cuh's
    reduce_grid."""
    return min(max(int(vectors) - 1, 0).bit_length(), PACKED_LANES)


def unit_levels(length) -> np.ndarray:
    """Each unit's level: the largest l < UNIT_LEVELS with length <=
    UNIT_SLOTS >> l (a unit of 0 to 4 slots is at the last level)."""
    length = np.asarray(length, np.int64)
    return sum((length <= UNIT_SLOTS >> (l + 1)).astype(np.int64)
               for l in range(UNIT_LEVELS - 1))


def warp_tables(length, tile) -> tuple[np.ndarray, np.ndarray]:
    """The warp tables of units in kernel order (length and column tile of
    each; tile-major, longest first within a tile): for each log2_g <
    PACKED_LANES the first unit of every warp, then the unit count.  A
    run of units of one tile and one level l is cut into warps of
    min(2^l, 32 >> log2_g) units (the last may hold fewer), so a warp's
    units hold at most UNIT_SLOTS slots together.  Returns (the tables
    back to back, int32; PACKED_LANES + 1 offsets)."""
    length = np.asarray(length, np.int64)
    n = length.shape[0]
    level = unit_levels(length)
    key = np.asarray(tile, np.int64) * UNIT_LEVELS + level
    head = np.ones(n, bool)
    head[1:] = key[1:] != key[:-1]
    run_first = np.maximum.accumulate(np.where(head, np.arange(n), 0))
    pos = np.arange(n) - run_first
    tables = []
    for log2_g in range(PACKED_LANES):
        per_warp = np.minimum(1 << level, 32 >> log2_g)
        tables.append(np.append(np.flatnonzero(pos % per_warp == 0), n))
    off = np.cumsum([0] + [t.shape[0] for t in tables])
    return np.concatenate(tables).astype(np.int32), off.astype(np.int32)


def tile_order(row_start, row_len, cols, col_tile) -> np.ndarray | None:
    """The slot permutation (new slot i takes old slot order[i]) that
    groups each described row's slots by column tile (col // col_tile),
    keeping their order within a tile; None without col_tile or where
    every row is grouped already.  Slots no row describes stay."""
    if not col_tile:
        return None
    row_start, row_len = np.asarray(row_start, np.int64), np.asarray(row_len, np.int64)
    row, slot = _row_slots(row_start, row_len)
    tile = np.asarray(cols)[slot].astype(np.int64) // int(col_tile)
    moved = slot[np.lexsort((tile, row))]
    if np.array_equal(moved, slot):
        return None
    order = np.arange(np.asarray(cols).shape[0], dtype=np.int64)
    order[slot] = moved
    return order


def select_rows(layout, keep):
    """The layout (BellDev or SlotRows) restricted to the row descriptors
    where `keep` (bool, one per row) holds, with its work units cut
    anew: what a kernel call on part of the rows runs (measurement)."""
    keep = np.asarray(torch.as_tensor(keep).cpu())
    rows = [t.cpu().numpy()[keep] for t in (layout.row_start, layout.row_len, layout.row_node)]
    dev = layout.row_start.device
    return dataclasses.replace(
        layout, row_start=_put(rows[0], dev), row_len=_put(rows[1], dev),
        row_node=_put(rows[2], dev), units=WorkUnits.from_rows(*rows, dev))


def masked_units(layout, every: int = 2):
    """The layout with the occupancy (flat_vals) of every `every`-th unit
    of a split row set to 0 and its first split row wholly masked: units
    and rows that are all masked, for the kernels' checks (measurement and
    tests; nothing on the path calls it)."""
    vals = layout.flat_vals.clone()
    u = layout.units
    for i in (u.part >= 0).nonzero().flatten().tolist()[::every]:
        vals[int(u.start[i]) : int(u.start[i]) + int(u.length[i])] = 0
    if u.split_node.numel():
        row = int((layout.row_node == u.split_node[0]).nonzero().flatten()[0])
        s, n = int(layout.row_start[row]), int(layout.row_len[row])
        vals[s : s + n] = 0
    return dataclasses.replace(layout, flat_vals=vals)


def shifted_slots(layout, shift: int):
    """The layout with `shift` unused slots (column 0, value 0) before its
    own and its row descriptors and work units moved past them: unit
    starts past 2^31 for the kernels' checks of 64-bit offsets
    (measurement and tests; nothing on the path calls it).  Only what the
    kernels read is moved (flat_cols, flat_vals, row_start, units); the
    plain versions run on the layout itself."""
    def pad(t):
        out = t.new_zeros((shift + t.shape[0],))
        out[shift:] = t
        return out

    return dataclasses.replace(
        layout, flat_cols=pad(layout.flat_cols), flat_vals=pad(layout.flat_vals),
        row_start=layout.row_start + shift,
        units=dataclasses.replace(layout.units, start=layout.units.start + shift))


@dataclasses.dataclass
class BellDev:
    """Device tensors of a binned ELL (see data.ell.build_binned_ell).

    The first fields mirror gala_tpu's BellDev array for array.  The
    kernel's own view of the layout is one row descriptor per output
    row, built once on the host:

        row i (bin order) reads slots [row_start[i], row_start[i] +
        row_len[i]) of flat_cols/flat_vals and writes global row
        row_node[i].

    A bin row has row_len = k_b.  A hub's virtual rows are contiguous
    slots (data.ell: (vbase + t//K)*K + t%K == vbase*K + t), so a hub
    is ONE row of length n_virt*K_BIG.  The kernels run over `units`
    (WorkUnits of these rows): untiled, a bin row is one unit, a hub's
    units of UNIT_SLOTS = K_BIG slots are its virtual rows, and the merge
    of their partials is the big_vrow segment-sum.  With col_tile a row's
    slots are first grouped by column tile (ops.graph.tile_order; a hub's
    then cross its virtual rows, whose sums bin_vals/big_vals still give
    the row's total) and its units cut at the tile boundaries, so a bin
    row may be split too."""

    flat_cols: torch.Tensor              # (S,) int32
    flat_vals: torch.Tensor              # (S,) f32: bin_vals then big_vals
    bin_vals: tuple                      # per bin (n_b, k_b) f32 views of flat_vals
    big_vals: torch.Tensor | None        # (Vb, K_BIG) f32 view of flat_vals
    big_vrow: torch.Tensor | None        # (Vb,) int32 sorted
    diag: torch.Tensor | None            # (n_pad, 1) f32, global order
    out_index: torch.Tensor | None       # (n_pad,) int32 into bin-order+1 rows
    row_start: torch.Tensor              # (n_real,) int64 first slot of row i
    row_len: torch.Tensor                # (n_real,) int32 slots of row i
    row_node: torch.Tensor               # (n_real,) int32 global row of row i
    units: WorkUnits                     # the kernels' work units of these rows
    bin_ks: tuple
    bin_counts: tuple
    n_big: int
    n_real: int
    n_src: int                           # feature rows the slots read (max col + 1)
    slot_order: np.ndarray | None = None  # host: column tiling's slot permutation (tile_order)

    @classmethod
    def from_host(cls, hb, n_pad: int, n_real: int, device, col_tile: int = 0) -> "BellDev":
        """col_tile: column tiling (see the module docstring)."""
        def put(a):
            return _put(a, device)

        diag = None
        if hb.diag is not None:
            d = np.zeros((n_pad, 1), np.float32)
            d[:n_real, 0] = hb.diag
            diag = put(d)
        out_index = None
        if not hb.identity_order:
            # position of each global node in bin order; padding rows point
            # at the appended zero row (index n_real)
            inv = np.full(n_pad, n_real, np.int32)
            inv[hb.order] = np.arange(n_real, dtype=np.int32)
            out_index = put(inv)

        parts = list(hb.bin_vals)
        if hb.n_big:
            parts.append(hb.big_vals)
        vals = np.concatenate([p.reshape(-1) for p in parts]) if parts else np.zeros(0, np.float32)
        row_start, row_len, row_node = _row_descriptors(hb)
        cols, order = hb.flat_cols, tile_order(row_start, row_len, hb.flat_cols, col_tile)
        if order is not None:
            cols, vals = cols[order], vals[order]
        flat_vals = put(vals)
        bin_vals, big_vals = bin_views(flat_vals, hb.bin_ks, hb.bin_counts, hb.n_big,
                                       hb.big_vals.shape[1] if hb.n_big else 0)

        return cls(
            flat_cols=put(cols),
            flat_vals=flat_vals,
            bin_vals=bin_vals,
            big_vals=big_vals,
            big_vrow=put(hb.big_vrow) if hb.big_vrow is not None else None,
            diag=diag,
            out_index=out_index,
            row_start=put(row_start),
            row_len=put(row_len),
            row_node=put(row_node),
            units=WorkUnits.from_rows(row_start, row_len, row_node, device, cols, col_tile),
            bin_ks=hb.bin_ks,
            bin_counts=hb.bin_counts,
            n_big=hb.n_big,
            n_real=n_real,
            n_src=int(hb.flat_cols.max()) + 1 if hb.flat_cols.size else 0,
            slot_order=order,
        )

    def to(self, device, memo: dict | None = None) -> "BellDev":
        """The layout on `device`; bin_vals and big_vals stay views of the
        moved flat_vals."""
        memo = {} if memo is None else memo
        vals = moved(self.flat_vals, device, memo)
        big_k = self.big_vals.shape[1] if self.n_big else 0
        bin_vals, big_vals = bin_views(vals, self.bin_ks, self.bin_counts, self.n_big, big_k)
        return _moved_fields(self, device, memo, flat_vals=vals, bin_vals=bin_vals,
                             big_vals=big_vals)


def _row_descriptors(hb):
    """(row_start, row_len, row_node), one entry per node in bin order
    (data.ell._segments gives each segment's flat offset); row_start
    int64, the rest int32."""
    lens = [np.full(nb, k, np.int64) for k, nb in zip(hb.bin_ks, hb.bin_counts)]
    if hb.n_big:
        nvirt = np.bincount(hb.big_vrow, minlength=hb.n_big).astype(np.int64)
        lens.append(nvirt * hb.big_vals.shape[1])
    row_len = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    row_start = np.zeros_like(row_len)
    np.cumsum(row_len[:-1], out=row_start[1:])
    if row_len.sum() != hb.flat_cols.shape[0]:
        raise ValueError("row descriptors do not cover the flat slots exactly")
    return row_start, row_len.astype(np.int32), np.asarray(hb.order, np.int32)


@dataclasses.dataclass
class SlotRows:
    """An 'ell' or 'segment' layout as the kernels read it (BellDev is the
    'bell' one): per-slot (column, value) pairs in `flat_cols` /
    `flat_vals`, and one descriptor per output row: row i reads slots
    [row_start[i], row_start[i] + row_len[i]) and writes global row
    row_node[i].  No diagonal split and no output reorder.

    Learned per-edge values (forward edge order) enter a layout as
    `slot_values(evals)` = evals[perm] * mask: `perm` maps each slot to a
    forward edge id, `mask` is 1.0 on the slots of real edges.  perm None:
    slot i is edge i (the forward edge list).  mask None: every slot takes
    its edge's value (the transpose edge list, whose padding slots read
    the last padded edge, as in gala_tpu's segment backward)."""

    flat_cols: torch.Tensor          # (S,) int32
    flat_vals: torch.Tensor          # (S,) f32 structural values, 0 on padding
    perm: torch.Tensor | None        # (S,) int32 (int64: long edge ids) forward edge id of each slot
    mask: torch.Tensor | None        # (S,) f32 1.0 on real slots
    row_start: torch.Tensor          # (R,) int64 first slot of row i
    row_len: torch.Tensor            # (R,) int32 slots of row i
    row_node: torch.Tensor           # (R,) int32 global row of row i
    units: WorkUnits                 # the kernels' work units of these rows
    k: int                           # ELL width (slots per virtual row); 0 for an edge list
    n_real: int                      # rows with a descriptor (R)
    n_src: int                       # feature rows the slots may read (> max col)
    slot_order: np.ndarray | None = None  # host: column tiling's slot permutation (tile_order)

    diag = None                      # the kernels' BellDev fields with no counterpart
    out_index = None

    def to(self, device, memo: dict | None = None) -> "SlotRows":
        return _moved_fields(self, device, {} if memo is None else memo)

    def slot_values(self, evals: torch.Tensor) -> torch.Tensor:
        """Per-edge values (E_pad,) -> per-slot values (S,)."""
        v = evals if self.perm is None else evals.index_select(0, self.perm)
        return v if self.mask is None else v * self.mask

    @classmethod
    def from_edge_list(cls, src: torch.Tensor, vals: torch.Tensor, perm: torch.Tensor | None,
                       row_ptr: np.ndarray, n_src: int, device, host_src: np.ndarray | None = None,
                       col_tile: int = 0, edge_id=np.int32) -> "SlotRows":
        """A padded dst-sorted edge list, one slot per edge, one row per
        padded destination (`row_ptr`: (rows + 1,) offsets).  With
        col_tile (`host_src`: src on the host), the slots grouped by
        column tile (tile_order of these rows): the layout then holds its
        own permuted columns and values, and `perm` maps its slots to edge
        ids, of the dtype `edge_id` (`perm` given: through it)."""
        rows = (row_ptr[:-1].astype(np.int64), np.diff(row_ptr).astype(np.int32),
                np.arange(row_ptr.shape[0] - 1, dtype=np.int32))
        order = tile_order(rows[0], rows[1], host_src, col_tile)
        if order is not None:
            idx = _put(order.astype(edge_id), device)
            src, vals, host_src = src.index_select(0, idx), vals.index_select(0, idx), host_src[order]
            perm = idx if perm is None else perm.index_select(0, idx)
        return cls(
            flat_cols=src, flat_vals=vals, perm=perm, mask=None,
            row_start=_put(rows[0], device), row_len=_put(rows[1], device),
            row_node=_put(rows[2], device),
            units=WorkUnits.from_rows(*rows, device, host_src, col_tile),
            k=0, n_real=row_ptr.shape[0] - 1, n_src=n_src, slot_order=order,
        )

    @classmethod
    def from_ell(cls, he, n_rows: int, n_edges: int, pad_edge_id: int, device,
                 edge_id=np.int32, col_tile: int = 0) -> "SlotRows":
        """A row-split ELL (data.ell.HostEll).  Its virtual rows are sorted
        and each node's are consecutive, so node v is ONE row of
        nvirt[v]*K slots from vstart[v]*K; the padded virtual rows past V
        get no descriptor.  Raises unless the descriptors hold every real
        slot, as `_row_descriptors` does for the binned layout.  `perm`
        takes the dtype `edge_id`; col_tile: column tiling (see the module
        docstring).  The host layout holds int32 edge ids (HostEll.perm,
        in gala_tpu too), so no ELL holds more than 2^31 - 1 slots."""
        k, v = he.k, he.n_virtual
        if v * k > _INT32_MAX:
            raise ValueError(f"{v * k} ELL slots: the host ELL (data.ell.HostEll) holds int32 "
                             "edge ids, so at most 2^31 - 1 slots")
        nvirt = np.bincount(he.vrow[:v], minlength=n_rows)
        if nvirt.shape[0] != n_rows or not np.array_equal(
                he.vrow[:v], np.repeat(np.arange(n_rows, dtype=he.vrow.dtype), nvirt)):
            raise ValueError("ELL virtual rows are not sorted and consecutive per node")
        perm = he.perm.reshape(-1)
        real = perm != pad_edge_id
        if real[v * k:].any() or int(real.sum()) != n_edges:
            raise ValueError("row descriptors do not cover the real ELL slots exactly")
        vstart = np.zeros(n_rows, np.int64)
        np.cumsum(nvirt[:-1], out=vstart[1:])
        rows = (vstart * k, (nvirt * k).astype(np.int32), np.arange(n_rows, dtype=np.int32))
        cols, vals, real = he.cols.reshape(-1), he.vals.reshape(-1), real.astype(np.float32)
        order = tile_order(rows[0], rows[1], cols, col_tile)
        if order is not None:
            cols, vals, perm, real = cols[order], vals[order], perm[order], real[order]
        return cls(
            flat_cols=_put(cols, device),
            flat_vals=_put(vals, device),
            perm=_put(perm.astype(edge_id), device),
            mask=_put(real, device),
            row_start=_put(rows[0], device), row_len=_put(rows[1], device),
            row_node=_put(rows[2], device),
            units=WorkUnits.from_rows(*rows, device, cols, col_tile),
            k=k, n_real=n_rows,
            n_src=int(he.cols.max()) + 1 if he.cols.size else 0,
            slot_order=order,
        )


@dataclasses.dataclass
class DynSlots:
    """Per-slot inputs of dynamic sampling on one row-descriptor layout
    (gala_tpu's DynMeta, expanded from rows to slots on the host): slot s
    lies at in-row position pos[s] of a row of deg[s] neighbors, the
    row's real in-degree (0 on padding rows).  Epoch weights w(deg, pos),
    in the layout's flat_vals order, are computed by the sampled SpMM
    (ops.kernels.bell_spmm.bell_spmm_sampled)."""

    deg: torch.Tensor    # (S,) int32
    pos: torch.Tensor    # (S,) int32

    def to(self, device, memo: dict | None = None) -> "DynSlots":
        return _moved_fields(self, device, {} if memo is None else memo)

    @classmethod
    def from_bell(cls, hb, deg_full: np.ndarray, device,
                  order: np.ndarray | None = None) -> "DynSlots":
        """From a binned ELL built with split_diag=False and the per-node
        degrees of the graph it holds: data.ell.build_dyn_row_meta's
        per-row (d, p), segment by segment (bins, then hub virtual rows),
        slot j of a row at position p + j; `order`: the device layout's
        column-tiling permutation (BellDev.slot_order)."""
        from gala_tpu_torch.data.ell import _segments, build_dyn_row_meta

        meta = build_dyn_row_meta(hb, deg_full)
        deg, pos = [], []
        for (k, _, _), d, p in zip(_segments(hb), meta.d, meta.p):
            deg.append(np.repeat(d[:, 0], k))
            pos.append((p + np.arange(k, dtype=np.int32)[None, :]).reshape(-1))
        cat = (lambda a: np.concatenate(a).astype(np.int32) if a  # noqa: E731
               else np.zeros(0, np.int32))
        deg, pos = cat(deg), cat(pos)
        if order is not None:
            deg, pos = deg[order], pos[order]
        return cls(deg=_put(deg, device), pos=_put(pos, device))

    @classmethod
    def from_ptr(cls, ptr: np.ndarray, row_deg: np.ndarray, device,
                 order: np.ndarray | None = None) -> "DynSlots":
        """From an edge-list layout's row offsets (rows + 1,), covering
        every slot, and each row's real degree (rows,); `order`: the
        layout's column-tiling permutation (SlotRows.slot_order)."""
        lens = np.diff(ptr)
        deg = np.repeat(row_deg, lens)
        pos = np.arange(int(ptr[-1]), dtype=np.int64) - np.repeat(ptr[:-1], lens)
        if order is not None:
            deg, pos = deg[order], pos[order]
        return cls(deg=_put(deg.astype(np.int32), device), pos=_put(pos.astype(np.int32), device))


@dataclasses.dataclass
class Graph:
    """A graph's aggregation layout on one device (+ transpose)."""

    # edge lists, forward (dst-sorted) and transpose (src-sorted), padded
    # to e_pad; None on 'bell' without edge values
    src: torch.Tensor | None        # (e_pad,) int32
    dst: torch.Tensor | None        # (e_pad,) int32 ascending
    vals: torch.Tensor | None       # (e_pad,) f32 structural values (0 on padding)
    t_src: torch.Tensor | None      # (e_pad,) int32
    t_dst: torch.Tensor | None      # (e_pad,) int32 ascending
    t_vals: torch.Tensor | None     # (e_pad,) f32
    t_perm: torch.Tensor | None     # (e_pad,) edge ids: forward edge id of transpose edge i
    row_ptr: torch.Tensor           # (n_pad+1,) edge ids: CSR offsets (padded rows empty)
    t_row_ptr: torch.Tensor         # (c_pad+1,) edge ids: transpose offsets
    a_dense: torch.Tensor | None    # (n_pad, c_pad) f32, only for 'dense'
    deg: torch.Tensor               # (n_pad, 1) f32 in-degrees (0 on padding)
    seg: SlotRows | None            # the edge lists as layouts, with the edge lists:
    t_seg: SlotRows | None          #   one row per padded node, the phantom row
                                    #   holding the padding edges
    ell: SlotRows | None            # row-split ELL, strategy 'ell'
    t_ell: SlotRows | None          # its transpose, slots -> forward edge ids
    bell: BellDev | None            # binned ELL, strategy 'bell'
    t_bell: BellDev | None          # its transpose (may alias bell)
    attn: AttnBell | None           # fused-attention layout (attention=True, 'bell')
    dyn_f: DynSlots | None          # dynamic sampling inputs of bell or seg
    dyn_t: DynSlots | None          #   and of its transpose (dynamic_sample=True)

    n_nodes: int            # real node count
    n_cols: int             # real source-side node count
    n_pad: int              # padded node count (>= n_nodes+1)
    c_pad: int              # padded source-side count
    n_edges: int            # real edge count
    e_pad: int              # padded edge count (>= n_edges+1)
    undirected: bool
    strategy: str
    device: torch.device

    @classmethod
    def from_host(
        cls,
        g: HostCSR,
        strategy: str = "auto",
        undirected: bool | None = None,
        device="cuda",
        edge_vals: bool = False,
        attention: bool = False,
        dynamic_sample: bool = False,
        col_tile: float | None = None,
        long_indices: bool = False,
        spans: dict | None = None,
    ) -> "Graph":
        """The padded edge lists, their transpose permutation and their
        layouts (`seg`, `t_seg`) are built where gala_tpu keeps them by
        default: with edge values, or on any strategy but 'bell' (which
        never reads them, dynamic_sample or not: its sampling runs on the
        bells).  dynamic_sample=True builds the bells with the self loops
        as slots and the sampling inputs `dyn_f`/`dyn_t` (see the module
        docstring), as gala_tpu's Graph.from_host(dynamic_sample=True).
        col_tile: source rows per column tile of every row-descriptor
        layout (column tiling, the module docstring); long_indices: int64
        edge ids, as gala_tpu's (on past 2^31 padded edges regardless).
        spans: where the fused-attention layout's build adds its host
        seconds, under `gala.lower.layout.attention` (utils.profiling)."""
        device = torch.device(device)
        # is_symmetric costs two full edge argsorts: only pay it when
        # the answer is consulted
        symmetric = is_symmetric(g) if undirected is None or undirected else False
        if undirected is None:
            undirected = symmetric

        n = g.n_rows
        c = g.n_cols
        n_pad = _round_up(n + 1, NODE_PAD)
        c_pad = _round_up(c + 1, NODE_PAD)
        e_real = g.n_edges
        # always at least one padded (zero-val) edge: edge e_pad-1 is the
        # sink of the ELL padding slots' permutation
        e_pad = _round_up(e_real + 1, EDGE_PAD)
        eid = np.int64 if long_indices or e_pad > _INT32_MAX else np.int32
        tile = max(int(col_tile), 1) if col_tile else 0
        if strategy == "auto":
            strategy = choose_strategy(n_pad, c_pad, e_real, edge_vals=edge_vals)
        if strategy == "pallas_bell":
            strategy = "bell"
        if strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        keep_edges = edge_vals or strategy != "bell"

        def pad_edges(dstv, srcv, valsv, phantom_dst):
            """The padded (dst, src, vals) on the device, and src on the host."""
            pad = e_pad - dstv.shape[0]
            dstv = np.concatenate([dstv, np.full(pad, phantom_dst, np.int64)]).astype(np.int32)
            srcv = np.concatenate([srcv, np.zeros(pad, np.int64)]).astype(np.int32)
            valsv = np.concatenate([valsv, np.zeros(pad, np.float32)])
            return _put(dstv, device), _put(srcv, device), _put(valsv, device), srcv

        def padded_ptr(counts, rows_pad):
            # the padding edges (phantom destination len(counts)) close the list
            ptr = np.full(rows_pad + 1, e_pad, np.int64)
            ptr[0] = 0
            np.cumsum(counts, out=ptr[1 : counts.shape[0] + 1])
            return ptr

        t_counts = np.bincount(g.src, minlength=c)
        dst = src = vals = t_dst = t_src = t_vals = t_perm = seg = t_seg = None
        dyn_f = dyn_t = None
        if keep_edges:
            dst, src, vals, src_h = pad_edges(g.dst, g.src, g.vals, n)
            # transpose edge list (backward pass); t_perm maps transpose
            # edge -> forward edge
            order = np.lexsort((g.dst.astype(np.int64), g.src.astype(np.int64)))
            t_dst, t_src, t_vals, t_src_h = pad_edges(g.src[order], g.dst[order], g.vals[order], c)
            t_perm = _put(np.concatenate(
                [order, np.full(e_pad - e_real, e_pad - 1, np.int64)]).astype(eid), device)
            ptr, t_ptr = padded_ptr(np.diff(g.row_ptr), n_pad), padded_ptr(t_counts, c_pad)
            seg = SlotRows.from_edge_list(src, vals, None, ptr, c, device, src_h, tile, eid)
            t_seg = SlotRows.from_edge_list(t_src, t_vals, t_perm, t_ptr, n, device, t_src_h, tile,
                                            eid)
            if dynamic_sample and strategy != "bell":
                # each row's real degree, 0 on the phantom row that holds
                # the padding edges (gala_tpu's deg and diff(t_row_ptr))
                def row_deg(counts, rows_pad):
                    return np.concatenate([counts, np.zeros(rows_pad - counts.shape[0], np.int64)])

                dyn_f = DynSlots.from_ptr(ptr, row_deg(np.diff(g.row_ptr), n_pad), device,
                                          seg.slot_order)
                dyn_t = DynSlots.from_ptr(t_ptr, row_deg(t_counts, c_pad), device,
                                          t_seg.slot_order)

        deg_np = np.zeros((n_pad, 1), np.float32)
        deg_np[:n, 0] = np.bincount(g.dst, minlength=n).astype(np.float32)

        # device CSR offsets (padded rows are empty), gala_tpu's arrays
        row_ptr_np = np.full(n_pad + 1, e_real, np.int64)
        row_ptr_np[: n + 1] = g.row_ptr
        t_row_ptr_np = np.full(c_pad + 1, e_real, np.int64)
        t_row_ptr_np[0] = 0
        t_row_ptr_np[1 : c + 1] = np.cumsum(t_counts)

        a_dense = None
        if strategy == "dense":
            d = np.zeros((n_pad, c_pad), np.float32)
            d[:n, :c] = densify(g)
            a_dense = _put(d, device)

        bell = t_bell = None
        if strategy == "bell":
            from gala_tpu_torch.data.ell import build_binned_ell

            hb = build_binned_ell(g, phantom_col=c, split_diag=not dynamic_sample)
            bell = BellDev.from_host(hb, n_pad, n, device, tile)
            if dynamic_sample:
                dyn_f = DynSlots.from_bell(hb, np.diff(g.row_ptr), device, bell.slot_order)
            # alias the backward layout ONLY when A == A^T by VALUE: a
            # structurally symmetric graph with asymmetric weights must
            # still get the true transpose
            if undirected and symmetric:
                t_bell, dyn_t = bell, dyn_f
            else:
                hbt = build_binned_ell(host_transpose(g), phantom_col=n,
                                       split_diag=not dynamic_sample)
                t_bell = BellDev.from_host(hbt, c_pad, c, device, tile)
                if dynamic_sample:
                    # the backward re-samples the transpose rows with the
                    # same (ra, rb), as gala_tpu: meta of their own degrees
                    dyn_t = DynSlots.from_bell(hbt, t_counts, device, t_bell.slot_order)

        ell = t_ell = None
        if strategy == "ell":
            from gala_tpu_torch.data.ell import build_ell

            he = build_ell(g, phantom_col=c, phantom_row=n, pad_edge_id=e_pad - 1)
            # transpose built with an explicitly stable order so each gt
            # edge j maps deterministically to forward edge t_order[j]
            # (the native counting sort is not stable across threads)
            t_order = np.argsort(g.src, kind="stable")
            gt_row_ptr = np.zeros(c + 1, np.int64)
            np.cumsum(t_counts, out=gt_row_ptr[1:])
            gt = HostCSR(
                n_rows=c, n_cols=n, row_ptr=gt_row_ptr,
                dst=g.src[t_order].astype(np.int32),
                src=g.dst[t_order].astype(np.int32),
                vals=g.vals[t_order],
            )
            # transpose slots map to *forward* edge ids so learned edge
            # values permute straight into the backward layout
            het = build_ell(gt, k=he.k, phantom_col=n, phantom_row=c, pad_edge_id=e_pad - 1)
            real = het.perm != e_pad - 1
            t_perm_slots = het.perm.copy()
            t_perm_slots[real] = t_order[het.perm[real]]
            het = dataclasses.replace(het, perm=t_perm_slots)
            ell = SlotRows.from_ell(he, n, e_real, e_pad - 1, device, eid, tile)
            t_ell = SlotRows.from_ell(het, c, e_real, e_pad - 1, device, eid, tile)

        attn = None
        if attention and strategy == "bell":
            from gala_tpu_torch.ops.attention import AttnBell

            with marker("gala.lower.layout.attention", into=spans):
                attn = AttnBell.from_host(g, n_pad, c_pad, device, tile)

        return cls(
            src=src, dst=dst, vals=vals,
            t_src=t_src, t_dst=t_dst, t_vals=t_vals, t_perm=t_perm,
            row_ptr=_put(row_ptr_np.astype(eid), device),
            t_row_ptr=_put(t_row_ptr_np.astype(eid), device),
            a_dense=a_dense,
            deg=_put(deg_np, device),
            seg=seg, t_seg=t_seg,
            ell=ell, t_ell=t_ell,
            bell=bell, t_bell=t_bell,
            attn=attn,
            dyn_f=dyn_f, dyn_t=dyn_t,
            n_nodes=n,
            n_cols=c,
            n_pad=n_pad,
            c_pad=c_pad,
            n_edges=e_real,
            e_pad=e_pad,
            undirected=undirected,
            strategy=strategy,
            device=device,
        )

    def to(self, device, memo: dict | None = None) -> "Graph":
        """The graph with every layout on `device` (ops.graph.moved)."""
        device = torch.device(device)
        return _moved_fields(self, device, {} if memo is None else memo, device=device)

    def pad_nodes(self, x: np.ndarray) -> torch.Tensor:
        """Pad a host (N, ...) node array to (n_pad, ...) on the device."""
        x = np.asarray(x)
        pad = self.n_pad - x.shape[0]
        if pad > 0:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return _put(x, self.device)


def choose_strategy(n_pad: int, c_pad: int, e_real: int, edge_vals: bool = False) -> str:
    """Input-aware strategy selection, gala_tpu's rule without its opt-in
    Pallas branch: small graphs densify; above the gate, learned or
    precomputed edge values take the row-split ELL (its slot -> edge-id
    permutation carries them into the layout), everything else binned
    ELL.  `e_real` keeps gala_tpu's signature; the rule does not read it."""
    if max(n_pad, c_pad) <= _DENSE_MAX_NODES:
        return "dense"
    return "ell" if edge_vals else "bell"
