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

Every sparse layout is read by the kernels through per-row descriptors
(`row_start`, `row_len`, `row_node` over `flat_cols`/`flat_vals`), so
one SpMM kernel executes all of them.

Edge lists (`src`, `dst`, `vals`, `t_*`, `t_perm`) are kept where gala_tpu
keeps them by default (with edge values, or off 'bell'), padded
to e_pad = round_up(E+1, 128) edges with dst = the phantom row, src 0
and value 0.  Node dimensions are padded as in gala_tpu (n_pad =
round_up(n+1, 8): at least one phantom row, which absorbs padding
slots).  'pallas_bell' raises NotImplementedError naming its ROADMAP
item.  With attention=True a 'bell' graph also carries the
fused-attention layout (`attn`, ops.attention.AttnBell); other
strategies build none and run the unfused chain, as gala_tpu does.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from gala_tpu_torch.data.csr import HostCSR, densify, is_symmetric
from gala_tpu_torch.data.csr import transpose as host_transpose

if TYPE_CHECKING:
    from gala_tpu_torch.ops.attention import AttnBell

EDGE_PAD = 128
NODE_PAD = 8
_DENSE_MAX_NODES = 16384  # N_pad^2 f32 <= 1GB (gala_tpu's gate, unchanged)
_STRATEGIES = ("dense", "bell", "ell", "segment", "segment_scan")
_MAX_EDGES = 2**31 - 1  # int32 edge ids and slot offsets

_NOT_PORTED = {
    "pallas_bell": "ROADMAP Queue 2 (the bell kernel is the only bell "
                   "executor on CUDA; use strategy='bell')",
}


def not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to gala_tpu_torch yet: {item}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


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
    is ONE row of length n_virt*K_BIG and the big_vrow segment-sum
    becomes the kernel's row loop."""

    flat_cols: torch.Tensor              # (S,) int32
    flat_vals: torch.Tensor              # (S,) f32: bin_vals then big_vals
    bin_vals: tuple                      # per bin (n_b, k_b) f32 views of flat_vals
    big_vals: torch.Tensor | None        # (Vb, K_BIG) f32 view of flat_vals
    big_vrow: torch.Tensor | None        # (Vb,) int32 sorted
    diag: torch.Tensor | None            # (n_pad, 1) f32, global order
    out_index: torch.Tensor | None       # (n_pad,) int32 into bin-order+1 rows
    row_start: torch.Tensor              # (n_real,) int32 first slot of row i
    row_len: torch.Tensor                # (n_real,) int32 slots of row i
    row_node: torch.Tensor               # (n_real,) int32 global row of row i
    bin_ks: tuple
    bin_counts: tuple
    n_big: int
    n_real: int
    n_src: int                           # feature rows the slots read (max col + 1)

    @classmethod
    def from_host(cls, hb, n_pad: int, n_real: int, device) -> "BellDev":
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
        flat_vals = put(np.concatenate([p.reshape(-1) for p in parts])
                        if parts else np.zeros(0, np.float32))
        bin_vals, off = [], 0
        for k, nb in zip(hb.bin_ks, hb.bin_counts):
            bin_vals.append(flat_vals[off : off + nb * k].view(nb, k))
            off += nb * k
        big_vals = flat_vals[off:].view(-1, hb.big_vals.shape[1]) if hb.n_big else None

        row_start, row_len, row_node = _row_descriptors(hb)
        return cls(
            flat_cols=put(hb.flat_cols),
            flat_vals=flat_vals,
            bin_vals=tuple(bin_vals),
            big_vals=big_vals,
            big_vrow=put(hb.big_vrow) if hb.big_vrow is not None else None,
            diag=diag,
            out_index=out_index,
            row_start=put(row_start),
            row_len=put(row_len),
            row_node=put(row_node),
            bin_ks=hb.bin_ks,
            bin_counts=hb.bin_counts,
            n_big=hb.n_big,
            n_real=n_real,
            n_src=int(hb.flat_cols.max()) + 1 if hb.flat_cols.size else 0,
        )


def _row_descriptors(hb):
    """(row_start, row_len, row_node) int32, one entry per node in bin
    order (data.ell._segments gives each segment's flat offset)."""
    lens = [np.full(nb, k, np.int64) for k, nb in zip(hb.bin_ks, hb.bin_counts)]
    if hb.n_big:
        nvirt = np.bincount(hb.big_vrow, minlength=hb.n_big).astype(np.int64)
        lens.append(nvirt * hb.big_vals.shape[1])
    row_len = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    row_start = np.zeros_like(row_len)
    np.cumsum(row_len[:-1], out=row_start[1:])
    if row_len.sum() != hb.flat_cols.shape[0]:
        raise ValueError("row descriptors do not cover the flat slots exactly")
    return (row_start.astype(np.int32), row_len.astype(np.int32),
            np.asarray(hb.order, np.int32))


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
    perm: torch.Tensor | None        # (S,) int32 forward edge id of each slot
    mask: torch.Tensor | None        # (S,) f32 1.0 on real slots
    row_start: torch.Tensor          # (R,) int32 first slot of row i
    row_len: torch.Tensor            # (R,) int32 slots of row i
    row_node: torch.Tensor           # (R,) int32 global row of row i
    k: int                           # ELL width (slots per virtual row); 0 for an edge list
    n_real: int                      # rows with a descriptor (R)
    n_src: int                       # feature rows the slots may read (> max col)

    diag = None                      # the kernels' BellDev fields with no counterpart
    out_index = None

    def slot_values(self, evals: torch.Tensor) -> torch.Tensor:
        """Per-edge values (E_pad,) -> per-slot values (S,)."""
        v = evals if self.perm is None else evals.index_select(0, self.perm)
        return v if self.mask is None else v * self.mask

    @classmethod
    def from_edge_list(cls, src: torch.Tensor, vals: torch.Tensor, perm: torch.Tensor | None,
                  row_ptr: np.ndarray, n_src: int, device) -> "SlotRows":
        """A padded dst-sorted edge list, one slot per edge, one row per
        padded destination (`row_ptr`: (rows + 1,) offsets)."""
        return cls(
            flat_cols=src, flat_vals=vals, perm=perm, mask=None,
            row_start=_put(row_ptr[:-1].astype(np.int32), device),
            row_len=_put(np.diff(row_ptr).astype(np.int32), device),
            row_node=_put(np.arange(row_ptr.shape[0] - 1, dtype=np.int32), device),
            k=0, n_real=row_ptr.shape[0] - 1, n_src=n_src,
        )

    @classmethod
    def from_ell(cls, he, n_rows: int, n_edges: int, pad_edge_id: int, device) -> "SlotRows":
        """A row-split ELL (data.ell.HostEll).  Its virtual rows are sorted
        and each node's are consecutive, so node v is ONE row of
        nvirt[v]*K slots from vstart[v]*K; the padded virtual rows past V
        get no descriptor.  Raises unless the descriptors hold every real
        slot, as `_row_descriptors` does for the binned layout."""
        k, v = he.k, he.n_virtual
        if v * k > _MAX_EDGES:
            raise not_ported("more than 2^31 ELL slots", "ROADMAP Queue 1 item 9")
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
        return cls(
            flat_cols=_put(he.cols.reshape(-1), device),
            flat_vals=_put(he.vals.reshape(-1), device),
            perm=_put(perm, device),
            mask=_put(real.astype(np.float32), device),
            row_start=_put((vstart * k).astype(np.int32), device),
            row_len=_put((nvirt * k).astype(np.int32), device),
            row_node=_put(np.arange(n_rows, dtype=np.int32), device),
            k=k, n_real=n_rows,
            n_src=int(he.cols.max()) + 1 if he.cols.size else 0,
        )


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
    t_perm: torch.Tensor | None     # (e_pad,) int32 forward edge id of transpose edge i
    row_ptr: torch.Tensor           # (n_pad+1,) int32 CSR offsets (padded rows empty)
    t_row_ptr: torch.Tensor         # (c_pad+1,) int32 transpose offsets
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
        device="cpu",
        edge_vals: bool = False,
        attention: bool = False,
    ) -> "Graph":
        """The padded edge lists, their transpose permutation and their
        layouts (`seg`, `t_seg`) are built where gala_tpu keeps them by
        default: with edge values, or on any strategy but 'bell' (which
        never reads them)."""
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
        if e_pad > _MAX_EDGES:
            raise not_ported("more than 2^31 edges (int64 edge ids)", "ROADMAP Queue 1 item 9")
        if strategy == "auto":
            strategy = choose_strategy(n_pad, c_pad, e_real, edge_vals=edge_vals)
        if strategy in _NOT_PORTED:
            raise not_ported(f"strategy {strategy!r}", _NOT_PORTED[strategy])
        if strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        keep_edges = edge_vals or strategy != "bell"

        def pad_edges(dstv, srcv, valsv, phantom_dst):
            pad = e_pad - dstv.shape[0]
            dstv = np.concatenate([dstv, np.full(pad, phantom_dst, np.int64)]).astype(np.int32)
            srcv = np.concatenate([srcv, np.zeros(pad, np.int64)]).astype(np.int32)
            valsv = np.concatenate([valsv, np.zeros(pad, np.float32)])
            return _put(dstv, device), _put(srcv, device), _put(valsv, device)

        def padded_ptr(counts, rows_pad):
            # the padding edges (phantom destination len(counts)) close the list
            ptr = np.full(rows_pad + 1, e_pad, np.int64)
            ptr[0] = 0
            np.cumsum(counts, out=ptr[1 : counts.shape[0] + 1])
            return ptr

        t_counts = np.bincount(g.src, minlength=c)
        dst = src = vals = t_dst = t_src = t_vals = t_perm = seg = t_seg = None
        if keep_edges:
            dst, src, vals = pad_edges(g.dst, g.src, g.vals, n)
            # transpose edge list (backward pass); t_perm maps transpose
            # edge -> forward edge
            order = np.lexsort((g.dst.astype(np.int64), g.src.astype(np.int64)))
            t_dst, t_src, t_vals = pad_edges(g.src[order], g.dst[order], g.vals[order], c)
            t_perm = _put(np.concatenate(
                [order, np.full(e_pad - e_real, e_pad - 1, np.int64)]).astype(np.int32), device)
            seg = SlotRows.from_edge_list(src, vals, None,
                                          padded_ptr(np.diff(g.row_ptr), n_pad), c, device)
            t_seg = SlotRows.from_edge_list(t_src, t_vals, t_perm,
                                            padded_ptr(t_counts, c_pad), n, device)

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

            hb = build_binned_ell(g, phantom_col=c)
            bell = BellDev.from_host(hb, n_pad, n, device)
            # alias the backward layout ONLY when A == A^T by VALUE: a
            # structurally symmetric graph with asymmetric weights must
            # still get the true transpose
            if undirected and symmetric:
                t_bell = bell
            else:
                hbt = build_binned_ell(host_transpose(g), phantom_col=n)
                t_bell = BellDev.from_host(hbt, c_pad, c, device)

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
            ell = SlotRows.from_ell(he, n, e_real, e_pad - 1, device)
            t_ell = SlotRows.from_ell(het, c, e_real, e_pad - 1, device)

        attn = None
        if attention and strategy == "bell":
            from gala_tpu_torch.ops.attention import AttnBell

            attn = AttnBell.from_host(g, n_pad, c_pad, device)

        return cls(
            src=src, dst=dst, vals=vals,
            t_src=t_src, t_dst=t_dst, t_vals=t_vals, t_perm=t_perm,
            row_ptr=_put(row_ptr_np.astype(np.int32), device),
            t_row_ptr=_put(t_row_ptr_np.astype(np.int32), device),
            a_dense=a_dense,
            deg=_put(deg_np, device),
            seg=seg, t_seg=t_seg,
            ell=ell, t_ell=t_ell,
            bell=bell, t_bell=t_bell,
            attn=attn,
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
