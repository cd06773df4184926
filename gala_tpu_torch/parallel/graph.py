"""Destination-partitioned graph layout for sharded execution (the port of
gala_tpu.parallel.graph).

Nodes are range-partitioned over the mesh's 'data' axis: shard s owns
rows [s*r, (s+1)*r), the edges whose destination it owns (so every
aggregation reduces locally) and those rows' features.  Source features
of other shards arrive by an all_gather of the feature matrix or, with
the halo layout, by an all_to_all of only the boundary rows each peer
reads (parallel.ops).

`ShardedGraph.from_host` builds gala_tpu's host arrays unchanged (the
numpy body is copied): per shard Es = El + Er edge slots, the El slots
of edges whose source it owns first, then the remote ones, each block
in CSR order and padded with edges into the phantom row r; the global
in-degrees; the halo layout (`send_idx`, `src_halo`, H).  `local(rank,
device, group)` gives one rank's tensors (`ShardGraph`).

The binned layouts (use_bell) are one per rank, over the rank's gather
table [local rows (r) | halo rows (S*H) | zero row]: the forward layout
(rows: local destinations; slots: table rows), its transpose (rows:
table rows; slots: local destinations, the zero row r of dz), and with
`attention` the fused attention's pair, occupancy-valued.  They are the
port's ops.graph.BellDev (row descriptors and work units), so the SpMM
and attention kernels run them as any single-device layout.  gala_tpu
pads every shard's layouts to one static structure with inert fake rows
whose ids clamp to the zero row, because one SPMD program is traced for
every device; a process per rank needs no common structure, so there
are no fake rows, and no index relies on clamping: every pad slot reads
the table's zero row (column n_tab) or dz's (column r), every pad slot
value reads [evals | 0]'s appended zero, every edge outside a layout
reads [slot grads | 0]'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gala_tpu_torch.data.csr import HostCSR
from gala_tpu_torch.data.ell import build_binned_ell
from gala_tpu_torch.ops.attention import AttnBell
from gala_tpu_torch.ops.graph import BellDev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard_bell(dst, src, vals, n_rows: int, n_cols: int, eids=None, n_edges: int = 0):
    """A binned ELL (no diagonal split) of one shard's edges: rows
    [0, n_rows), slots reading columns [0, n_cols), pad slots column
    n_cols (the zero row).  The CSR is built with an explicit stable sort
    by destination, so with `eids` (each edge's position in the shard's
    edge array) every slot maps back to its edge: returns (layout,
    slot_eid or None), pad slots' slot_eid = n_edges."""
    dst = np.asarray(dst, np.int64)
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_rows), out=row_ptr[1:])
    g = HostCSR(n_rows=n_rows, n_cols=n_cols + 1, row_ptr=row_ptr,
                dst=dst[order].astype(np.int32), src=np.asarray(src)[order].astype(np.int32),
                vals=np.asarray(vals, np.float32)[order])
    hb = build_binned_ell(g, phantom_col=n_cols, split_diag=False,
                          with_edge_ids=eids is not None)
    if eids is None:
        return hb, None
    lookup = np.concatenate([np.asarray(eids, np.int64)[order], [n_edges]])
    return hb, lookup[hb.flat_edge]


def invert_slot_eids(slot_eid: np.ndarray, n_edges: int) -> np.ndarray:
    """The slot of each shard edge position (gala_tpu's _invert_slot_eids);
    edges not in the layout (shard padding) point at the appended zero
    slot s_total."""
    s_total = slot_eid.shape[0]
    soe = np.full(n_edges, s_total, np.int32)
    real = slot_eid < n_edges
    soe[slot_eid[real]] = np.nonzero(real)[0].astype(np.int32)
    return soe


@dataclasses.dataclass
class SlotEdges:
    """Learned edge values on one rank's bell layouts (gala_tpu's
    ShardedBell.edge_perm and slot_of_edge): the slot values of evals
    (Es,) are [evals | 0][edge_perm], the transpose's [evals |
    0][t_edge_perm]; the per-slot gradients <x[slot_src], dz[slot_dst]>
    (the SDDMM kernel over the forward layout's slots, in slot order) go
    back to edges as [dslot | 0][slot_of_edge]."""

    edge_perm: torch.Tensor      # (S_f,) int64 shard edge of each forward slot, pad -> Es
    t_edge_perm: torch.Tensor    # (S_t,) int64 the same for the transpose's slots
    slot_src: torch.Tensor       # (S_f,) int32 table row each forward slot reads
    slot_dst: torch.Tensor       # (S_f,) int32 local row each forward slot writes
    slot_of_edge: torch.Tensor   # (Es,) int64 forward slot of each edge, outside -> S_f


@dataclasses.dataclass
class ShardGraph:
    """One rank's share of a ShardedGraph, on its device: what the op
    layer (ops.spmm, ops.edge, the interpreter) receives in place of a
    single-device Graph, dispatching on strategy == "spmd" to
    parallel.ops, whose collectives run over `group` (the mesh's data
    group).  `tp_plan` and `model_group`: tensor parallelism
    (parallel.tp), read by the interpreter's FFN lowering."""

    src: torch.Tensor          # (Es,) int32 global source ids
    dst_local: torch.Tensor    # (Es,) int32 destination - s*r; padding -> r
    vals: torch.Tensor         # (Es,) f32, 0 on padding
    occ: torch.Tensor          # (Es,) f32 1.0 per real edge (softmax and attention mask)
    deg: torch.Tensor          # (r, 1) f32 in-degrees of the local rows
    src_halo: torch.Tensor     # (Es,) int32 into [local | halo] ([0, El) local, then r + halo)
    send_idx: torch.Tensor     # (S, H) int32 local rows sent to each peer
    bell: BellDev | None
    t_bell: BellDev | None
    attn: AttnBell | None
    ev: SlotEdges | None
    rank: int
    n_shards: int
    rows_per_shard: int
    n_pad: int
    n_nodes: int
    edges_per_shard: int
    edges_local: int
    halo: int
    use_halo: bool
    device: torch.device
    group: object = None
    tp_plan: dict | None = None
    model_group: object = None

    strategy = "spmd"

    @property
    def local_rows(self) -> int:
        """Node rows this rank owns: the leading dim of its node tensors."""
        return self.rows_per_shard

    @property
    def n_tab(self) -> int:
        """Rows of the gather table before its zero row: r + S*H."""
        return self.rows_per_shard + self.n_shards * self.halo


@dataclasses.dataclass
class ShardedGraph:
    """Destination-partitioned edge lists of every shard, host arrays of
    shape (S, ...), gala_tpu's arrays with the shard axis leading."""

    src: np.ndarray        # (S, Es) int32 global source ids
    dst_local: np.ndarray  # (S, Es) int32 dst - s*r; padding -> phantom row r
    vals: np.ndarray       # (S, Es) f32, 0 on padding
    occ: np.ndarray        # (S, Es) f32 1.0 per real edge
    deg: np.ndarray        # (S*r, 1) f32 in-degrees
    src_halo: np.ndarray   # (S, Es) int32 [0, El): local row ids, [El, Es): r + halo slot
    send_idx: np.ndarray   # (S, S, H) int32 local rows shard p sends to q
    n_shards: int
    rows_per_shard: int
    n_pad: int
    n_nodes: int
    edges_per_shard: int
    edges_local: int
    halo: int
    use_halo: bool = False
    use_bell: bool = False
    attention: bool = False
    edge_vals: bool = False

    @classmethod
    def from_host(cls, g: HostCSR, n_shards: int, use_halo: bool = False,
                  use_bell: bool = False, attention: bool = False,
                  edge_vals: bool = False) -> "ShardedGraph":
        """The host build of gala_tpu (its numpy body); the binned layouts come
        per rank from `local`.  use_bell implies use_halo."""
        if use_bell:
            use_halo = True  # the bell layouts index the [local|halo] table
        n = g.n_rows
        r = _round_up(max((n + n_shards - 1) // n_shards, 8), 8)
        n_pad = r * n_shards

        shard_of = g.dst // r
        src_of = g.src // r
        is_local = src_of == shard_of
        per_shard_l = np.bincount(shard_of[is_local], minlength=n_shards)
        per_shard_r = np.bincount(shard_of[~is_local], minlength=n_shards)
        el = _round_up(max(int(per_shard_l.max()), 1), 128)
        er = _round_up(max(int(per_shard_r.max()), 1), 128)
        es = el + er

        src = np.zeros((n_shards, es), np.int32)
        dstl = np.full((n_shards, es), r, np.int32)  # phantom row r
        vals = np.zeros((n_shards, es), np.float32)
        reals = np.zeros((n_shards, es), bool)
        for s in range(n_shards):
            sel_l = (shard_of == s) & is_local
            sel_r = (shard_of == s) & ~is_local
            kl, kr = int(sel_l.sum()), int(sel_r.sum())
            src[s, :kl] = g.src[sel_l]
            dstl[s, :kl] = g.dst[sel_l] - s * r
            vals[s, :kl] = g.vals[sel_l]
            reals[s, :kl] = True
            src[s, el : el + kr] = g.src[sel_r]
            dstl[s, el : el + kr] = g.dst[sel_r] - s * r
            vals[s, el : el + kr] = g.vals[sel_r]
            reals[s, el : el + kr] = True

        deg = np.zeros((n_pad, 1), np.float32)
        deg[:n, 0] = np.bincount(g.dst, minlength=n)

        # ---- halo layout: per (owner q <- sender p) boundary row lists.
        # need[s][q] = sorted unique sources shard s reads from shard q.
        need = []
        for s in range(n_shards):
            srcs = src[s][reals[s]]
            owner = srcs // r
            need.append([
                np.unique(srcs[owner == q]) if q != s else np.zeros(0, np.int64)
                for q in range(n_shards)
            ])
        h = max(
            (len(need[s][q]) for s in range(n_shards) for q in range(n_shards)),
            default=1,
        )
        h = _round_up(max(h, 1), 8)
        send_idx = np.zeros((n_shards, n_shards, h), np.int32)
        for p in range(n_shards):
            for q in range(n_shards):
                rows = need[q][p] - p * r       # p-local ids q needs
                send_idx[p, q, : len(rows)] = rows
        # remap sources into the per-shard [local | halo] table:
        # owned u -> u - s*r ; remote u (owner q) -> r + q*h + pos(need[s][q], u)
        src_halo = np.full((n_shards, es), r, np.int32)  # phantom -> a local pad row
        for s in range(n_shards):
            srcs = src[s][reals[s]].astype(np.int64)
            owner = srcs // r
            local = srcs - s * r
            for q in range(n_shards):
                sel = owner == q
                if q == s or not sel.any():
                    continue
                local[sel] = r + q * h + np.searchsorted(need[s][q], srcs[sel])
            dest = np.full(es, r, np.int64)
            dest[np.nonzero(reals[s])[0]] = local
            src_halo[s] = dest.astype(np.int32)

        return cls(src=src, dst_local=dstl, vals=vals, occ=reals.astype(np.float32), deg=deg,
                   src_halo=src_halo, send_idx=send_idx, n_shards=n_shards, rows_per_shard=r,
                   n_pad=n_pad, n_nodes=n, edges_per_shard=es, edges_local=el, halo=h,
                   use_halo=use_halo, use_bell=use_bell, attention=use_bell and attention,
                   edge_vals=use_bell and edge_vals)

    def local(self, rank: int, device, group=None) -> ShardGraph:
        """Shard `rank`'s tensors on `device`, with its binned layouts
        (use_bell) built here: only the rank that runs them pays for them.
        `group`: the process group of the shards (the mesh's data group)."""
        s, r, es = rank, self.rows_per_shard, self.edges_per_shard
        bell = t_bell = attn = ev = None
        if self.use_bell:
            n_tab = r + self.n_shards * self.halo
            real = self.occ[s] > 0
            dst, src, vals = self.dst_local[s][real], self.src_halo[s][real], self.vals[s][real]
            eids = np.nonzero(real)[0] if self.edge_vals else None
            hb, slot_eid = shard_bell(dst, src, vals, r, n_tab, eids, es)
            bell = BellDev.from_host(hb, r + 1, r, device)
            # transpose: rows = table positions, slots read dz (zero row r)
            hbt, t_slot_eid = shard_bell(src, dst, vals, n_tab, r, eids, es)
            t_bell = BellDev.from_host(hbt, n_tab + 1, n_tab, device)
            if self.edge_vals:
                slot_dst = torch.repeat_interleave(bell.row_node, bell.row_len.long())
                ev = SlotEdges(edge_perm=_put(slot_eid, device),
                               t_edge_perm=_put(t_slot_eid, device), slot_src=bell.flat_cols,
                               slot_dst=slot_dst.to(torch.int32),
                               slot_of_edge=_put(invert_slot_eids(slot_eid, es).astype(np.int64),
                                                 device))
            if self.attention:
                # occupancy values: a real edge of weight 0.0 stays in the softmax
                ones = np.ones(dst.shape[0], np.float32)
                attn = AttnBell(
                    fwd=BellDev.from_host(shard_bell(dst, src, ones, r, n_tab)[0], r + 1, r,
                                          device),
                    t=BellDev.from_host(shard_bell(src, dst, ones, n_tab, r)[0], n_tab + 1,
                                        n_tab, device),
                    n_edges=int(dst.shape[0]))
        return ShardGraph(
            src=_put(self.src[s], device), dst_local=_put(self.dst_local[s], device),
            vals=_put(self.vals[s], device), occ=_put(self.occ[s], device),
            deg=_put(self.deg[s * r : (s + 1) * r], device),
            src_halo=_put(self.src_halo[s], device), send_idx=_put(self.send_idx[s], device),
            bell=bell, t_bell=t_bell, attn=attn, ev=ev, rank=rank, n_shards=self.n_shards,
            rows_per_shard=r, n_pad=self.n_pad, n_nodes=self.n_nodes, edges_per_shard=es,
            edges_local=self.edges_local, halo=self.halo, use_halo=self.use_halo,
            device=torch.device(device), group=group)

    def pad_nodes(self, x: np.ndarray) -> np.ndarray:
        """A host (N, ...) node array padded to (n_pad, ...)."""
        x = np.asarray(x)
        pad = self.n_pad - x.shape[0]
        if pad > 0:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return x

    def rows_of(self, x: np.ndarray, rank: int) -> np.ndarray:
        """Shard `rank`'s rows of a host node array, padded."""
        r = self.rows_per_shard
        return self.pad_nodes(x)[rank * r : (rank + 1) * r]
