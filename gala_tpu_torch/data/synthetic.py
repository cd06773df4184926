"""Synthetic graph generators (R-MAT, random geometric, planted-label).

TPU-native counterpart of the reference's generators
(reference: src/utils/generator.h:36-365 `generate_rmat`, `generate_rgg2D`).
Used by tests and by the dataset registry when real OGB/Planetoid npy data
is absent (this image has no network egress).
"""
from __future__ import annotations

import numpy as np

from gala_tpu_torch.data.csr import coo_to_csr, normalize_self_loops, symmetrize, HostCSR


def rmat_edges(
    n: int,
    n_edges: int,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT edge list (reference: src/utils/generator.h:36 `generate_rmat`)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    acc_t = np.int32 if scale < 31 else np.int64
    src = np.zeros(n_edges, dtype=acc_t)
    dst = np.zeros(n_edges, dtype=acc_t)
    # quadrant draw via one float32 uniform + two thresholds per level —
    # rng.choice(p=...) is several times slower at 46M draws
    t_ab = np.float32(a + b)    # u <= a: quad a; a < u <= a+b: quad b
    t_abc = np.float32(a + b + c)  # (t_ab, t_abc]: quad c; else: quad d
    a32 = np.float32(a)
    for level in range(scale):
        u = rng.random(n_edges, dtype=np.float32)
        bit = acc_t(1 << (scale - 1 - level))
        src_bit = u > t_ab                      # quads c, d
        dst_bit = (u > t_abc) | ((u > a32) & ~src_bit)  # quads d, b
        src += bit * src_bit
        dst += bit * dst_bit
    keep = (src < n) & (dst < n)
    return src[keep].astype(np.int64), dst[keep].astype(np.int64)


def rgg2d_edges(n: int, radius: float, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random geometric graph in the unit square
    (reference: src/utils/generator.h `generate_rgg2D`)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    from gala_tpu_torch import native

    nat = native.rgg2d_native(pts, radius)
    if nat is not None:
        return nat
    # grid-bucket neighbor search, O(n) for constant expected degree
    cell = max(radius, 1e-6)
    gx = (pts[:, 0] / cell).astype(np.int64)
    gy = (pts[:, 1] / cell).astype(np.int64)
    ncell = int(np.ceil(1.0 / cell))
    bucket: dict[tuple[int, int], list[int]] = {}
    for i in range(n):
        bucket.setdefault((int(gx[i]), int(gy[i])), []).append(i)
    srcs, dsts = [], []
    r2 = radius * radius
    for (cx, cy), members in bucket.items():
        cand: list[int] = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cand.extend(bucket.get((cx + dx, cy + dy), []))
        cand_arr = np.asarray(cand)
        for i in members:
            d2 = np.sum((pts[cand_arr] - pts[i]) ** 2, axis=1)
            nb = cand_arr[(d2 < r2) & (cand_arr != i)]
            srcs.append(np.full(nb.shape[0], i, dtype=np.int64))
            dsts.append(nb.astype(np.int64))
    if not srcs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(srcs), np.concatenate(dsts)


def rgg2d_dataset(
    n: int,
    avg_degree: int = 16,
    n_feats: int = 128,
    n_classes: int = 32,
    train_frac: float = 0.3,
    val_frac: float = 0.2,
    seed: int = 0,
):
    """Geometric node-classification dataset (reference generator family:
    src/utils/generator.h `generate_rgg2D`) with spatial-tile node ids.

    Node ids are assigned in grid-cell order — the layout a real
    geometric/mesh dataset export ships with (spatial tiles), and the
    one a locality-preserving reorder (data.reordering.bfs_order, the
    reference's R9 load-time reordering) reconstructs from scratch:
    measured staged-row reuse 4.2 (spatial sort) vs 3.4 (BFS from
    random ids) vs 0.14 (random ids) on the dominant degree-class
    segment.  Above the Pallas break-even (~2), the fused bell kernels
    engage end-to-end on this family — the planted-community R-MAT
    stand-ins never clear 0.19 because their 'communities' span the
    whole id space.

    Labels are grid regions => homophily is geometric (neighbors share
    a region), so the accuracy oracle is meaningful.
    """
    # feats/split draw from an INDEPENDENT stream: default_rng(seed)
    # is the exact PCG64 stream that produces pts (below and inside
    # rgg2d_edges), and reusing it would correlate features and split
    # assignment with node positions — which also define the labels —
    # leaking extra label signal into the accuracy oracle (ADVICE r4)
    rng = np.random.default_rng((seed, 1))
    radius = float(np.sqrt(avg_degree / (np.pi * n)))
    src, dst = rgg2d_edges(n, radius, seed=seed)
    # spatial-tile id order along a MORTON (Z-order) curve of the SAME
    # pts the generator drew (same rng consumption order: pts first).
    # Row-major grid keys split every 2D neighborhood across ncell-apart
    # strips: at 1.5M nodes the k=24 plan lands at staged-row reuse 1.97
    # (a hair under the 2.0 break-even) because the worst strip-spanning
    # chunk sets the global block-table width; the Z-curve keeps
    # neighborhoods id-contiguous and lifts the same plan to 3.43
    # (k=16: 2.36), putting ~84% of slots above break-even.
    pts = np.random.default_rng(seed).random((n, 2))
    cell = max(radius, 1e-6)

    def _spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    gx = (pts[:, 0] / cell).astype(np.int64)
    gy = (pts[:, 1] / cell).astype(np.int64)
    key = _spread(gx) | (_spread(gy) << np.uint64(1))
    order = np.argsort(key, kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    src, dst = inv[src], inv[dst]
    pts = pts[order]

    src, dst = normalize_self_loops(src, dst, n)
    g = coo_to_csr(src, dst, None, n_rows=n)

    # labels: coarse spatial regions (~n_classes cells), noisy edges of
    # the region borders keep accuracy < 1
    rc = max(int(np.ceil(np.sqrt(n_classes))), 1)
    labels = (
        (pts[:, 0] * rc).astype(np.int64) * rc + (pts[:, 1] * rc).astype(np.int64)
    ) % n_classes
    feats = rng.normal(0.0, 1.0, size=(n, n_feats)).astype(np.float32)
    feats[np.arange(n), labels % n_feats] += 2.0

    perm = rng.permutation(n)
    masks = {}
    lo = 0
    for name, frac in (("train", train_frac), ("val", val_frac), ("test", None)):
        m = np.zeros(n, dtype=bool)
        hi = n if frac is None else lo + int(frac * n)
        m[perm[lo:hi]] = True
        masks[name] = m
        lo = hi
    return g, feats, labels, masks


def synthetic_dataset(
    n: int = 512,
    avg_degree: int = 8,
    n_feats: int = 32,
    n_classes: int = 7,
    train_frac: float = 0.3,
    val_frac: float = 0.2,
    seed: int = 0,
    undirected: bool = True,
):
    """A small planted-community node-classification dataset.

    Returns the same tuple layout as the GALA npy loader
    (gala_tpu_torch.data.io.load_gala_npy): (HostCSR, feats, labels, masks dict).
    Features are noisy class indicators so a 2-layer GCN reaches high
    accuracy quickly — the accuracy-as-oracle test strategy of the
    reference (SURVEY.md §4, reference: scripts/Evaluations/Table-7.py).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n, dtype=np.int64)

    # community-biased edges: ~70% intra-class
    e = n * avg_degree
    src = rng.integers(0, n, size=e, dtype=np.int64)
    same = rng.random(e) < 0.7
    # pick intra-class partner: random member of same class
    class_members = [np.flatnonzero(labels == c) for c in range(n_classes)]
    dst = rng.integers(0, n, size=e, dtype=np.int64)
    for c in range(n_classes):
        sel = same & (labels[src] == c)
        if class_members[c].size:
            dst[sel] = rng.choice(class_members[c], size=int(sel.sum()))
    if undirected:
        src, dst = symmetrize(src, dst, n)
    src, dst = normalize_self_loops(src, dst, n)
    g = coo_to_csr(src, dst, None, n_rows=n)

    feats = rng.normal(0.0, 1.0, size=(n, n_feats)).astype(np.float32)
    feats[np.arange(n), labels % n_feats] += 2.5

    perm = rng.permutation(n)
    n_train = int(train_frac * n)
    n_val = int(val_frac * n)
    train_mask = np.zeros(n, dtype=bool)
    val_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train : n_train + n_val]] = True
    test_mask[perm[n_train + n_val :]] = True
    masks = {"train": train_mask, "val": val_mask, "test": test_mask}
    return g, feats, labels, masks
