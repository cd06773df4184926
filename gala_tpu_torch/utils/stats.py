"""Input statistics for input-aware scheduling and analysis.

Clean-room equivalents of the reference's "approx" statistics
(reference: src/ops/approx.h) and matrix-property analysis
(reference: src/formats/matrix_prop.h MtxStats/DistStats).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from gala_tpu_torch.data.csr import HostCSR


def approx_range(g: HostCSR, n_tiles: int = 16) -> np.ndarray:
    """Per-row-tile (min, max) of source ids — the column-span signal the
    reference computes per tile (reference: src/ops/approx.h:11)."""
    bounds = np.linspace(0, g.n_rows, n_tiles + 1).astype(np.int64)
    out = np.zeros((n_tiles, 2), np.int64)
    for t in range(n_tiles):
        lo = g.row_ptr[bounds[t]]
        hi = g.row_ptr[bounds[t + 1]]
        seg = g.src[lo:hi]
        if seg.size:
            out[t] = (seg.min(), seg.max())
    return out


def approx_reorder_metric(g: HostCSR, sample: int = 100_000) -> dict:
    """Average |src - dst| distance and mean closest-neighbor distance —
    reorder quality (reference: src/ops/approx.h:122 approx_reord_met)."""
    e = g.n_edges
    if e == 0:
        return {"avg_distance": 0.0, "closest_neighbor": 0.0}
    idx = np.linspace(0, e - 1, min(sample, e)).astype(np.int64)
    dist = np.abs(g.src[idx].astype(np.int64) - g.dst[idx].astype(np.int64))
    closest = np.zeros(0)
    rows = np.unique(g.dst[idx])[:1000]
    mins = []
    for r in rows:
        lo, hi = g.row_ptr[r], g.row_ptr[r + 1]
        if hi > lo:
            mins.append(np.abs(g.src[lo:hi].astype(np.int64) - r).min())
    return {
        "avg_distance": float(dist.mean()),
        "closest_neighbor": float(np.mean(mins)) if mins else 0.0,
    }


def degree_entropy(g: HostCSR, frac: float = 0.1) -> float:
    """Entropy of the degree distribution of the first `frac` rows
    (reference: src/ops/approx.h:188 approx_vert_entr)."""
    n = max(int(g.n_rows * frac), 1)
    deg = np.diff(g.row_ptr[: n + 1]).astype(np.float64)
    total = deg.sum()
    if total <= 0:
        return 0.0
    p = deg[deg > 0] / total
    return float(-(p * np.log2(p)).sum())


@dataclasses.dataclass
class MtxStats:
    """Row/degree-distribution summary (reference: matrix_prop.h MtxStats)."""

    n_rows: int
    n_cols: int
    n_edges: int
    density: float
    mean_degree: float
    max_degree: int
    std_degree: float
    empty_rows: int
    degree_entropy: float

    @classmethod
    def of(cls, g: HostCSR) -> "MtxStats":
        deg = g.degrees.astype(np.float64)
        return cls(
            n_rows=g.n_rows,
            n_cols=g.n_cols,
            n_edges=g.n_edges,
            density=g.density(),
            mean_degree=float(deg.mean()) if deg.size else 0.0,
            max_degree=int(deg.max()) if deg.size else 0,
            std_degree=float(deg.std()) if deg.size else 0.0,
            empty_rows=int((deg == 0).sum()),
            degree_entropy=degree_entropy(g, frac=1.0),
        )


@dataclasses.dataclass
class DistStats:
    """Distribution summary of a nonneg count vector (reference:
    matrix_prop.h DistStats; the *_nz twins restrict to nonzero
    entries).  gini: mean absolute difference / (2*mean) via the
    sorted-weights identity; pratio: participation ratio
    (sum x)^2 / (n * sum x^2) — 1.0 = perfectly even, 1/n = one spike."""

    min: float
    max: float
    sum: float
    mean: float
    median: float
    variance: float
    stddev: float
    gini: float
    pratio: float
    nonzero: int
    nelems: int
    nonzero_ratio: float
    mean_nz: float
    stddev_nz: float

    @classmethod
    def of(cls, counts: np.ndarray) -> "DistStats":
        x = np.asarray(counts, np.float64).reshape(-1)
        n = x.size
        if n == 0:
            return cls(*([0.0] * 9), 0, 0, 0.0, 0.0, 0.0)
        nz = x[x > 0]
        s = float(x.sum())
        xs = np.sort(x)
        i = np.arange(1, n + 1, dtype=np.float64)
        gini = float((2 * i - n - 1) @ xs / (n * s)) if s > 0 else 0.0
        pratio = float(s * s / (n * (x @ x))) if s > 0 else 0.0
        return cls(
            min=float(x.min()),
            max=float(x.max()),
            sum=s,
            mean=float(x.mean()),
            median=float(np.median(x)),
            variance=float(x.var()),
            stddev=float(x.std()),
            gini=gini,
            pratio=pratio,
            nonzero=int(nz.size),
            nelems=n,
            nonzero_ratio=float(nz.size / n),
            mean_nz=float(nz.mean()) if nz.size else 0.0,
            stddev_nz=float(nz.std()) if nz.size else 0.0,
        )


def tile_stats(g: HostCSR, blk_r: int = 128, blk_c: int = 128):
    """nnz-per-tile / per-row-block / per-col-block distributions
    (reference: matrix_prop.h MtxStats t_*/rb_*/cb_* fields) — the
    tile-locality signal the reference's input-aware scheduling reads.

    Returns dict with DistStats for 'row', 'col', 'tile', 'row_block',
    'col_block'."""
    nr_b = -(-g.n_rows // blk_r)
    nc_b = -(-g.n_cols // blk_c)
    rb = g.dst // blk_r
    cb = g.src // blk_c
    tiles = np.bincount(rb * nc_b + cb, minlength=nr_b * nc_b)
    return {
        "row": DistStats.of(np.diff(g.row_ptr)),
        "col": DistStats.of(np.bincount(g.src, minlength=g.n_cols)),
        "tile": DistStats.of(tiles),
        "row_block": DistStats.of(np.bincount(rb, minlength=nr_b)),
        "col_block": DistStats.of(np.bincount(cb, minlength=nc_b)),
    }


def check_equal(g1: HostCSR, g2: HostCSR, check_vals: bool = True):
    """Structured graph comparator (reference: tests/common.h:529-575
    check_equal): staged dims -> offsets -> columns -> values check.
    Returns (equal: bool, reason: str)."""
    if g1.n_rows != g2.n_rows or g1.n_cols != g2.n_cols:
        return False, "dims differ"
    if not np.array_equal(g1.row_ptr, g2.row_ptr):
        return False, "offsets differ"
    if not np.array_equal(g1.src, g2.src):
        return False, "columns differ"
    if check_vals and not np.allclose(g1.vals, g2.vals):
        return False, "values differ"
    return True, "equal"
