"""Input-aware compilation: derive the schedule from the actual input.

Clean-room equivalent of the reference's `opt_input` driver path
(reference: tests/gala_inference.cpp:84-131): when the DSL says
`G.opt_input(path)`, the compiler loads the real graph, reads sizes and
density, and fills in the schedule instead of trusting hand-written
directives.  The reference sets coarsen=2 always and col_tile = nrows/5
when density > 0.001; the claim is schedules within 10% of hand-tuned
(reference: docs PDF §3.6).

On TPU the knobs are different: the decision that matters is the SpMM
execution strategy (dense MXU vs segment vs scanned-segment — see
gala_tpu_torch.ops.graph.choose_strategy) plus the scan chunk (the col-tile
analog) and block coarsening for the Pallas path.  The degree-entropy
signal the reference computes but does not use (reference:
src/ops/approx.h:188-226 `approx_vert_entr`) is exposed for schedule
decisions too.
"""
from __future__ import annotations

import numpy as np

from gala_tpu_torch.data.csr import HostCSR
from gala_tpu_torch.dsl.spec import ModelSpec


def degree_entropy(g: HostCSR, frac: float = 0.1) -> float:
    """Entropy of the degree distribution of the first `frac` of rows
    (reference: src/ops/approx.h:188 `approx_vert_entr`)."""
    n = max(int(g.n_rows * frac), 1)
    deg = np.diff(g.row_ptr[: n + 1]).astype(np.float64)
    total = deg.sum()
    if total <= 0:
        return 0.0
    p = deg[deg > 0] / total
    return float(-(p * np.log2(p)).sum())


def autoschedule(spec: ModelSpec, g: HostCSR, n_feats: int, n_classes: int) -> ModelSpec:
    """Fill schedule fields from the measured input (in place)."""
    spec.graph.feat_size = n_feats
    spec.graph.label_size = n_classes
    if spec.output_sizes and spec.output_sizes[-1] in (0, -3):
        spec.output_sizes[-1] = n_classes

    # reference heuristic: coarsen=2 always; col_tile nrows/5 when
    # density > 0.001.  On TPU the coarsen analog (binned-ELL blocking)
    # is kept, but col_tile is NOT emitted: forcing the chunked paths
    # below the memory budget is a measured LOSS on this hardware
    # (results_r3/stat_table5.csv, Reddit-0.25: dir 1.36s vs none 0.78s
    # inference — schedule-driven chunking exists for memory, not speed,
    # and the executor already chunks by budget when buffers would not
    # fit).  Strategy selection from the real graph (density, size,
    # edge-value needs) happens at lowering via choose_strategy either
    # way, so opt_input's job here is sizes + coarsening only.
    spec.compute.coarsen = max(spec.compute.coarsen, 2)
    return spec
