"""Neighbor sampling (host / NumPy).

Clean-room equivalents of the reference's samplers:
- `inplace_sample_graph` (reference: src/ops/tiling.h:389-453): true
  random choice of `k` incoming neighbors per node, CSR rebuilt.
- `inplace_sample_graph_ab` (reference: src/ops/tiling.h:454-512): the
  deterministic LCG pick j = (ra*i + rb) % deg, chosen to agree with the
  in-kernel sampling formula so data-level and kernel-level sampling
  select identical neighbors.

Kernel-level sampling on TPU is realized the same way — as an index
transform producing a fixed-degree edge list — because a fixed k per
node yields exactly the rectangular, static-shape layout TPUs want
(it is literally an ELL format).
"""
from __future__ import annotations

import numpy as np

from gala_tpu_torch.data.csr import HostCSR, coo_to_csr


def sample_graph_random(g: HostCSR, k: int, seed: int = 0) -> HostCSR:
    """Keep up to k random incoming neighbors per destination node.

    Vectorized: random keys per edge, lexsort within rows, keep the
    first k of each row (O(E log E), no per-row Python)."""
    rng = np.random.default_rng(seed)
    r = rng.random(g.n_edges)
    order = np.lexsort((r, g.dst))            # rows ascending, random inside
    pos_in_row = np.arange(g.n_edges, dtype=np.int64) - g.row_ptr[g.dst[order]]
    idx = order[pos_in_row < k]
    return coo_to_csr(g.src[idx], g.dst[idx], g.vals[idx], g.n_rows, g.n_cols)


def sample_graph_ab(g: HostCSR, k: int, ra: int = 5, rb: int = 7) -> HostCSR:
    """Deterministic LCG sampling: the i-th sample of a row with degree d
    is neighbor (ra*i + rb) % d (reference: tiling.h:454 and the in-kernel
    formula cuda.h:313-320).  Duplicate picks are kept, as in the
    reference (sum aggregation then weights repeated neighbors).
    Vectorized over all rows (the reference parallelizes with OpenMP)."""
    deg = np.diff(g.row_ptr)
    n_pick = np.minimum(deg, k)
    start = np.zeros(g.n_rows + 1, np.int64)
    np.cumsum(n_pick, out=start[1:])
    total = int(start[-1])
    row = np.repeat(np.arange(g.n_rows, dtype=np.int64), n_pick)
    i = np.arange(total, dtype=np.int64) - start[row]
    idx = g.row_ptr[row] + (ra * i + rb) % deg[row]
    return coo_to_csr(g.src[idx], g.dst[idx], g.vals[idx], g.n_rows, g.n_cols)


def dynamic_sample_params(epoch: int, seed: int = 0) -> tuple[int, int]:
    """Per-epoch (ra, rb) for dynamic kernel sampling (the reference draws
    fresh random ra/rb each epoch, src/codegen/common.h:822-833)."""
    rng = np.random.default_rng(seed + epoch)
    return int(rng.integers(1, 97)), int(rng.integers(0, 97))
