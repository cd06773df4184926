"""Row-split ELL layout: the TPU-native sparse format for aggregation.

Measured on TPU v5e (see SURVEY.md §6 targets): XLA's row gather runs at
180-320M rows/s but scatter (segment_sum) is row-rate-bound at ~98M
rows/s *independent of row width* — so the structure that wins is one
that keeps the gather (which is wide and partially bandwidth-bound) and
shrinks the scatter.  Row-split ELL does exactly that:

- every destination row is split into ceil(deg/K) *virtual rows* of
  exactly K source slots (phantom slots padded with val=0),
- pass 1 is fully regular: partial[v] = sum_k vals[v,k] * x[cols[v,k]]
  (a gather of V*K rows + a dense K-reduction, no scatter),
- pass 2 scatters only V = N + E/K rows (sorted segment_sum).

This is the TPU answer to the reference's register-coarsened CUDA SpMM
(reference: src/codegen/cuda.h:282-436): the K slots play the role of
the warp's per-thread neighbor loop, virtual-row splitting plays the
role of its `_offset` remainder kernels, and the layout doubles as the
blocked input a future fused Pallas kernel consumes.

K is chosen per graph from the mean degree (the coarsening analog of the
input-aware schedule, reference: tests/gala_inference.cpp:127).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from gala_tpu_torch.data.csr import HostCSR


@dataclasses.dataclass
class HostEll:
    cols: np.ndarray   # (V_pad, K) int32 source ids; phantom col on padding
    vals: np.ndarray   # (V_pad, K) f32; 0 on padding
    vrow: np.ndarray   # (V_pad,) int32 real destination row, sorted
    perm: np.ndarray   # (V_pad, K) int32 forward-edge id of each slot
                       # (E_pad-1, a guaranteed zero-val padded edge, on padding)
    n_virtual: int     # V (before padding to V_pad)
    k: int


# measured TPU v5e row-op rates (rows/s): gather is ~2x the scatter rate
_GATHER_RATE = 180e6
_SCATTER_RATE = 98e6


def choose_k(g: HostCSR, k_min: int = 4, k_max: int = 128) -> int:
    """Pick K minimizing modeled cost: padded-slot gathers at the gather
    rate plus V virtual-row scatters at the scatter rate.  Exact O(E)
    evaluation per candidate — the input-aware coarsening decision
    (analog of reference: tests/gala_inference.cpp:127 coarsen choice)."""
    deg = np.diff(g.row_ptr).astype(np.int64)
    best_k, best_cost = k_min, np.inf
    k = k_min
    while k <= k_max:
        nv = np.maximum((deg + k - 1) // k, 1)
        slots = int((nv * k).sum())
        v = int(nv.sum())
        cost = slots / _GATHER_RATE + v / _SCATTER_RATE
        if cost < best_cost:
            best_cost, best_k = cost, k
        k *= 2
    return best_k


def build_ell(
    g: HostCSR,
    k: int | None = None,
    phantom_col: int | None = None,
    phantom_row: int | None = None,
    pad_edge_id: int | None = None,
) -> HostEll:
    """Vectorized O(E) construction from a dst-sorted HostCSR."""
    if k is None:
        k = choose_k(g)
    n = g.n_rows
    e = g.n_edges
    phantom_col = g.n_cols if phantom_col is None else phantom_col
    phantom_row = n if phantom_row is None else phantom_row
    pad_edge_id = e if pad_edge_id is None else pad_edge_id

    deg = np.diff(g.row_ptr)
    nvirt = np.maximum((deg + k - 1) // k, 1).astype(np.int64)
    vstart = np.zeros(n + 1, np.int64)
    np.cumsum(nvirt, out=vstart[1:])
    v = int(vstart[-1])
    v_pad = ((v + 127) // 128) * 128

    cols = np.full((v_pad, k), phantom_col, np.int32)
    vals = np.zeros((v_pad, k), np.float32)
    perm = np.full((v_pad, k), pad_edge_id, np.int32)
    vrow = np.full(v_pad, phantom_row, np.int32)

    filled = False
    if e > 1_000_000:
        from gala_tpu_torch import native

        src32 = np.ascontiguousarray(g.src, dtype=np.int32)
        vals32 = np.ascontiguousarray(g.vals, dtype=np.float32)
        rp = np.ascontiguousarray(g.row_ptr, dtype=np.int64)
        filled = native.fill_ell_native(
            n, k, rp, src32, vals32, vstart, cols, vals, perm, vrow
        )
    if not filled:
        # slot of each edge: position within its destination row
        t = np.arange(e, dtype=np.int64) - g.row_ptr[g.dst]
        vidx = vstart[g.dst] + t // k
        slot = t % k
        cols[vidx, slot] = g.src
        vals[vidx, slot] = g.vals
        perm[vidx, slot] = np.arange(e, dtype=np.int32)
        vrow[:v] = np.repeat(np.arange(n, dtype=np.int32), nvirt)

    return HostEll(cols=cols, vals=vals, vrow=vrow, perm=perm, n_virtual=v, k=k)


def inflation(ell: HostEll, n_edges: int) -> float:
    """Padded-slot inflation factor (1.0 = no padding overhead)."""
    return ell.cols.shape[0] * ell.k / max(n_edges, 1)


# --------------------------------------------------------------------------- #
# Binned ELL (SELL-style): degree-class bins, scatter-free reduction
# --------------------------------------------------------------------------- #
# Measured on the v5e (scripts/microbench.py): the XLA row-gather rate is
# flat in table size and index order (~250-300M rows/s) while the sorted
# segment-sum scatter runs at only ~95M rows/s.  So the winning layout
# minimizes *scattered rows*, not locality: group nodes into degree-class
# bins where every node owns exactly ONE virtual row of width k_b, reduce
# each bin with a dense reshape-sum (no scatter at all), and keep a tiny
# segment-sum only for hub nodes with degree > BIN_SIZES[-1].  Self-loop
# (diagonal) values are split out and applied as an elementwise product,
# removing one gathered slot per node.
#
# The per-class widths play the role of the reference's register
# coarsening factors (reference: src/codegen/cuda.h:282-436 `_coarseN`
# kernels and their `_offset` remainder variants); the degree-class node
# relabeling is the reference's degree reordering made load-time
# (reference: src/ops/reordering.h:1085 getAcendingOrder).

BIN_SIZES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
K_BIG = 128

# canonical slots per gather chunk: 2^19 slots * 128 phys lanes * 2B
# (bf16) = 134MB per live chunk buffer — the same budget as
# ops.spmm._BELL_CHUNK_ELEMS for f_phys=128.  Stage tables (below) are
# built on these boundaries so host and device agree on the chunking.
S_CHUNK = 1 << 19


@dataclasses.dataclass
class HostBinnedEll:
    flat_cols: np.ndarray            # (S,) int32: all bins' slots then big part
    bin_vals: list[np.ndarray]       # per bin (n_b, k_b) float32
    bin_ks: tuple[int, ...]          # static widths (only non-empty bins)
    bin_counts: tuple[int, ...]      # static node counts per bin
    big_vals: np.ndarray | None      # (Vb, K_BIG) float32
    big_vrow: np.ndarray | None      # (Vb,) int32 position in big segment, sorted
    n_big: int
    diag: np.ndarray | None          # (n,) float32 self-loop values (bin order!)
    order: np.ndarray                # (n,) node id at output position i
    identity_order: bool
    flat_edge: np.ndarray | None = None  # (S,) int64 edge id per slot (pad -> E)
    n_edges_kept: int = 0                # edges represented (after diag split)


@dataclasses.dataclass
class HostStageTables:
    """Per-chunk dedup tables for the staged (two-level) gather.

    Measured on the v5e (scripts/bench_staged_gather.py): a row gather
    from a table whose physical footprint exceeds ~100MB runs at
    ~158M rows/s while a gather from a small staged table (kept opaque
    with lax.optimization_barrier so XLA cannot fold the two gathers
    back into one) runs at ~435M rows/s.  Deduplicating each chunk's
    source ids and gathering only the unique rows from the big table
    (stage 1, slow rate but few rows) then distributing them with a
    small-table gather (stage 2, fast rate, all slots) wins whenever
    the per-chunk unique fraction is below ~0.55:

        t_staged / t_plain = uniq_frac + r_slow/r_fast  (~ u + 0.36)

    Chunk boundaries are the canonical S_CHUNK slots so the device
    kernel (ops.spmm._bell_bin_reduce) iterates identically."""

    uniq: list[np.ndarray]    # per chunk, (U_pad,) int32 sorted unique ids
    local: list[np.ndarray]   # per chunk, (rows*k,) int32 indices into uniq
    chunk_rows: list[tuple]   # per chunk (seg_idx, lo, hi) for validation
    uniq_frac: float          # sum(U) / sum(slots)


def _segments(hb: "HostBinnedEll"):
    """(k, n_rows, flat_off) per segment: the bins then the hub block —
    the exact iteration order of ops.spmm._bell_raw."""
    segs = []
    off = 0
    for k, nb in zip(hb.bin_ks, hb.bin_counts):
        segs.append((k, nb, off))
        off += nb * k
    if hb.n_big:
        vb, kb = hb.big_vals.shape
        segs.append((kb, vb, off))
        off += vb * kb
    return segs


def stage_chunks(k: int, n_rows: int, chunk_slots: int = 0):
    """Canonical chunk bounds [(lo, hi), ...] in rows for a k-wide
    segment.  chunk_slots 0 means the canonical S_CHUNK; a
    schedule-driven column tile (`col_tile` directive, the reference's
    ordered column tiling — reference: src/ops/tiling.h:222-284)
    overrides it so the DIR axis changes the executed chunk
    granularity."""
    rows = max((chunk_slots or S_CHUNK) // k, 1)
    return [(lo, min(n_rows, lo + rows)) for lo in range(0, n_rows, rows)]


def build_stage_tables(
    hb: "HostBinnedEll", chunk_slots: int = 0
) -> HostStageTables:
    """Dedup every canonical chunk of every segment (one-time host cost,
    O(S log S_CHUNK) via per-chunk sorts; the chunks are independent, so
    the native OpenMP path parallelizes them — the serial np.unique
    fallback dominates setup minutes at papers100M scale)."""
    bounds, meta = [], []
    for si, (k, n_rows, off) in enumerate(_segments(hb)):
        for lo, hi in stage_chunks(k, n_rows, chunk_slots):
            bounds.append((off + lo * k, off + hi * k))
            meta.append((si, lo, hi))

    uniqs, locals_ = [], []
    total_u = total_s = 0

    from gala_tpu_torch import native

    nat = (
        native.stage_dedup_native(hb.flat_cols, bounds)
        if hb.flat_cols.shape[0] > 2_000_000 else None
    )
    for ci, (b0, b1) in enumerate(bounds):
        if nat is not None:
            uniq_buf, counts, local_buf = nat
            u = uniq_buf[b0 : b0 + int(counts[ci])].copy()
            inv = local_buf[b0:b1]
        else:
            u, inv = np.unique(hb.flat_cols[b0:b1], return_inverse=True)
        pad = (-u.shape[0]) % 8
        if pad:
            u = np.concatenate([u, np.full(pad, u[-1], u.dtype)])
        uniqs.append(np.ascontiguousarray(u, np.int32))
        locals_.append(np.ascontiguousarray(inv, np.int32))
        total_u += u.shape[0]
        total_s += b1 - b0
    return HostStageTables(
        uniq=uniqs, local=locals_, chunk_rows=meta,
        uniq_frac=total_u / max(total_s, 1),
    )


@dataclasses.dataclass
class HostDynMeta:
    """Per-segment metadata for dynamic in-kernel neighbor sampling
    executed as SLOT REWEIGHTING on the static bell layout.

    The reference's dynamic mode re-rolls (ra, rb) per epoch and its
    kernels read neighbor (ra*i + rb) %% deg for i < n_samples
    (reference: src/codegen/cuda.h:313-320, common.h:822-833).  Summing
    those k picks WITH repetition is identical to weighting CSR
    position p of a degree-d row by

        w(d, p) = #{ i < n_samples : (ra*i + rb) mod d == p }

    so the sampled aggregation is the ordinary bell aggregation with
    per-epoch computed slot weights — zero per-epoch index gathers, and
    the staged/Pallas gather machinery applies unchanged
    (ops.spmm._spmm_dyn_bell).  Slot j of a segment row has in-row
    position pos0 + j (pos0 nonzero only for hub virtual rows).  The
    backward side carries its own meta over the TRANSPOSE rows: the
    reference re-samples the transpose with the same (ra, rb) in its
    2*layer+1 kernels rather than transposing the sampled matrix."""

    d: list                 # per segment: (nb, 1) int32 row degree
    p: list                 # per segment: (nb, 1) int32 slot-0 offset


def build_dyn_row_meta(hb: "HostBinnedEll", deg_full: np.ndarray) -> HostDynMeta:
    """Forward-side sampling meta.  deg_full: per-node degree of the
    graph hb was built from (hb MUST be built with split_diag=False so
    slot positions equal CSR positions — the reference samples over the
    full row, self loops included)."""
    assert hb.diag is None, "dynamic bells must be built with split_diag=False"
    deg_bin = deg_full[hb.order].astype(np.int64)
    ds, ps = [], []
    off = 0
    for k, nb in zip(hb.bin_ks, hb.bin_counts):
        ds.append(deg_bin[off : off + nb].reshape(nb, 1).astype(np.int32))
        ps.append(np.zeros((nb, 1), np.int32))
        off += nb
    if hb.n_big:
        hub_deg = deg_bin[off : off + hb.n_big]
        nv = np.maximum((hub_deg + K_BIG - 1) // K_BIG, 1)
        vb = int(nv.sum())
        ds.append(np.repeat(hub_deg, nv).reshape(vb, 1).astype(np.int32))
        starts = np.zeros(hb.n_big, np.int64)
        np.cumsum(nv[:-1], out=starts[1:])
        voff = (np.arange(vb, dtype=np.int64) - np.repeat(starts, nv)) * K_BIG
        ps.append(voff.reshape(vb, 1).astype(np.int32))
    return HostDynMeta(d=ds, p=ps)


def _bell_classes(deg: np.ndarray) -> np.ndarray:
    """Degree-class id per node; len(BIN_SIZES) = the hub class."""
    cls = np.searchsorted(BIN_SIZES, np.maximum(deg, 1)).astype(np.int32)
    return np.where(deg > BIN_SIZES[-1], len(BIN_SIZES), cls).astype(np.int32)


def _split_diag(g: HostCSR, split_diag: bool):
    """Return (src, dst, vals, diag) with self-loops removed if requested."""
    src, dst, vals = g.src, g.dst, g.vals
    diag = None
    if split_diag and g.n_rows == g.n_cols:
        self_mask = src == dst
        if self_mask.any():
            diag = np.zeros(g.n_rows, np.float32)
            np.add.at(diag, dst[self_mask], vals[self_mask])
            keep = ~self_mask
            src, dst, vals = src[keep], dst[keep], vals[keep]
    return src, dst, vals, diag


def bell_order(g: HostCSR, split_diag: bool = True) -> np.ndarray:
    """The degree-class permutation build_binned_ell uses internally.

    Relabeling a graph with this order ahead of time makes the binned
    layout's output order the identity (no per-SpMM reindex gather)."""
    _, dst, _, _ = _split_diag(g, split_diag)
    deg = np.bincount(dst, minlength=g.n_rows)
    return np.argsort(_bell_classes(deg), kind="stable").astype(np.int64)


def build_binned_ell(
    g: HostCSR,
    phantom_col: int | None = None,
    split_diag: bool = True,
    with_edge_ids: bool = False,
    native_min_edges: int = 2_000_000,
) -> HostBinnedEll:
    """Vectorized O(E) construction from a dst-sorted HostCSR.

    with_edge_ids additionally records the (post-diag-split) edge id of
    every slot (pad slots -> E sentinel), which lets a transpose layout
    map its slots onto forward slots (fused attention backward)."""
    n = g.n_rows
    phantom_col = g.n_cols if phantom_col is None else phantom_col

    src, dst, vals, diag = _split_diag(g, split_diag)
    e = src.shape[0]
    deg = np.bincount(dst, minlength=n).astype(np.int64)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])

    cls = _bell_classes(deg)
    n_classes = len(BIN_SIZES) + 1
    order = np.argsort(cls, kind="stable").astype(np.int64)
    identity = bool(np.array_equal(order, np.arange(n)))
    pos = np.empty(n, np.int64)          # node -> position in bin order
    pos[order] = np.arange(n)
    class_count = np.bincount(cls, minlength=n_classes)
    class_start = np.zeros(n_classes + 1, np.int64)
    np.cumsum(class_count, out=class_start[1:])
    pos_in_bin = pos - class_start[cls]  # per node

    ks = np.asarray(list(BIN_SIZES) + [K_BIG], np.int64)
    # big nodes: ceil(deg/K_BIG) virtual rows each
    big_ids = order[class_start[-2]:]    # hub nodes in bin order
    n_big = int(big_ids.shape[0])
    nvirt_big = (deg[big_ids] + K_BIG - 1) // K_BIG if n_big else np.zeros(0, np.int64)
    vb = int(nvirt_big.sum())
    vrow_start = np.zeros(n_big + 1, np.int64)
    np.cumsum(nvirt_big, out=vrow_start[1:])

    # flat slot layout: [bin 0 | bin 1 | ... | big (vb * K_BIG)]
    bin_flat_start = np.zeros(n_classes + 1, np.int64)
    np.cumsum(class_count[:-1] * ks[:-1], out=bin_flat_start[1 : n_classes])
    bin_flat_start[-1] = bin_flat_start[-2] + vb * K_BIG
    s_total = int(bin_flat_start[-1])

    flat_cols = np.full(s_total, phantom_col, np.int32)
    flat_vals = np.zeros(s_total, np.float32)
    flat_edge = np.full(s_total, e, np.int64) if with_edge_ids else None

    if e:
        # absolute slot of node v's t-th edge is slot_base[v] + t for all
        # classes (a hub's contiguous virtual rows give
        # (vbase + t//K)*K + t%K == vbase*K + t)
        is_big_node = cls == n_classes - 1
        slot_base = bin_flat_start[cls] + pos_in_bin * ks[cls]
        if n_big:
            slot_base[is_big_node] = (
                bin_flat_start[-2] + vrow_start[pos_in_bin[is_big_node]] * K_BIG
            )
        filled = False
        if e > native_min_edges:
            from gala_tpu_torch import native

            filled = native.fill_bell_native(
                np.ascontiguousarray(dst, np.int32),
                np.ascontiguousarray(src, np.int32),
                np.ascontiguousarray(vals, np.float32),
                np.ascontiguousarray(row_ptr, np.int64),
                np.ascontiguousarray(slot_base, np.int64),
                flat_cols, flat_vals, flat_edge,
            )
        if not filled:
            slot = slot_base[dst] + (np.arange(e, dtype=np.int64) - row_ptr[dst])
            flat_cols[slot] = src
            flat_vals[slot] = vals
            if with_edge_ids:
                flat_edge[slot] = np.arange(e, dtype=np.int64)

    bin_ks, bin_counts, bin_vals = [], [], []
    for b, k in enumerate(BIN_SIZES):
        nb = int(class_count[b])
        if nb == 0:
            continue
        lo, hi = int(bin_flat_start[b]), int(bin_flat_start[b + 1])
        bin_ks.append(int(k))
        bin_counts.append(nb)
        bin_vals.append(flat_vals[lo:hi].reshape(nb, k))

    big_vals = big_vrow = None
    if n_big:
        lo = int(bin_flat_start[-2])
        big_vals = flat_vals[lo:].reshape(vb, K_BIG)
        big_vrow = np.repeat(np.arange(n_big, dtype=np.int32), nvirt_big)

    return HostBinnedEll(
        flat_cols=flat_cols,
        bin_vals=bin_vals,
        bin_ks=tuple(bin_ks),
        bin_counts=tuple(bin_counts),
        big_vals=big_vals,
        big_vrow=big_vrow,
        n_big=n_big,
        diag=diag,  # GLOBAL node order (applied after output reindexing)
        order=order,
        identity_order=identity,
        flat_edge=flat_edge,
        n_edges_kept=e,
    )
