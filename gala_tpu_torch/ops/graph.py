"""Device-side graph container (the port of gala_tpu.ops.graph).

A `Graph` holds one graph's aggregation layout as torch tensors on one
device, for the two strategies this port executes:

    'dense'  the adjacency densified once; SpMM = `a_dense @ x`.
    'bell'   binned ELL (gala_tpu_torch.data.ell.build_binned_ell): every
             node owns one row of its degree class's width, hubs own
             ceil(deg/128) contiguous virtual rows.  Forward runs on
             `bell`, the backward on the transpose layout `t_bell`
             (aliased when A == A^T by value).

Node dimensions are padded as in gala_tpu (n_pad = round_up(n+1, 8): at
least one phantom row, which absorbs padding slots).  The other gala_tpu
strategies ('ell', 'segment', 'segment_scan', 'pallas_bell') raise
NotImplementedError naming their ROADMAP item; so do the fused attention
layout and dynamic sampling, in the lowering.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gala_tpu_torch.data.csr import HostCSR, densify, is_symmetric
from gala_tpu_torch.data.csr import transpose as host_transpose

NODE_PAD = 8
_DENSE_MAX_NODES = 16384  # N_pad^2 f32 <= 1GB (gala_tpu's gate, unchanged)

_NOT_PORTED = {
    "ell": "ROADMAP Queue 1 item 7 (GAT slice: the 'ell' strategy)",
    "segment": "ROADMAP Queue 1 item 7 (the 'segment' strategies)",
    "segment_scan": "ROADMAP Queue 1 item 7 (the 'segment' strategies)",
    "pallas_bell": "ROADMAP Queue 2 (the bell kernel is the only bell "
                   "executor on CUDA; use strategy='bell')",
}


def not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to gala_tpu_torch yet: {item}")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

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
class Graph:
    """A graph's aggregation layout on one device (+ transpose)."""

    a_dense: torch.Tensor | None    # (n_pad, c_pad) f32, only for 'dense'
    deg: torch.Tensor               # (n_pad, 1) f32 in-degrees (0 on padding)
    bell: BellDev | None            # binned ELL, strategy 'bell'
    t_bell: BellDev | None          # its transpose (may alias bell)

    n_nodes: int            # real node count
    n_cols: int             # real source-side node count
    n_pad: int              # padded node count (>= n_nodes+1)
    c_pad: int              # padded source-side count
    n_edges: int            # real edge count
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
    ) -> "Graph":
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
        if strategy == "auto":
            strategy = choose_strategy(n_pad, c_pad)
        if strategy in _NOT_PORTED:
            raise not_ported(f"strategy {strategy!r}", _NOT_PORTED[strategy])
        if strategy not in ("dense", "bell"):
            raise ValueError(f"unknown strategy {strategy!r}")

        deg_np = np.zeros((n_pad, 1), np.float32)
        deg_np[:n, 0] = np.bincount(g.dst, minlength=n).astype(np.float32)

        a_dense = None
        if strategy == "dense":
            d = np.zeros((n_pad, c_pad), np.float32)
            d[:n, :c] = densify(g)
            a_dense = torch.from_numpy(d).to(device)

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

        return cls(
            a_dense=a_dense,
            deg=torch.from_numpy(deg_np).to(device),
            bell=bell,
            t_bell=t_bell,
            n_nodes=n,
            n_cols=c,
            n_pad=n_pad,
            c_pad=c_pad,
            n_edges=g.n_edges,
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
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)


def choose_strategy(n_pad: int, c_pad: int) -> str:
    """Input-aware strategy selection, gala_tpu's rule for structural
    edge values without its opt-in Pallas branch: small graphs densify,
    everything else runs binned ELL.  (Learned edge values, which pick
    'ell' in gala_tpu, are refused by the lowering.)"""
    if max(n_pad, c_pad) <= _DENSE_MAX_NODES:
        return "dense"
    return "bell"
