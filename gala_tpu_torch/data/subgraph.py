"""Train-mask L-hop subgraph extraction (host / NumPy).

Clean-room equivalent of the reference's `getMaskSubgraphs`
(reference: tests/common.h:20-123, duplicated src/utils/common.h:25-128):
training gradients only touch nodes within L hops of the train mask, so
layer i of an L-layer GNN can aggregate over the subgraph of edges whose
destination reaches the mask within (L - i) hops.

Masks are grown by repeated backward propagation over edges (a max-
aggregate over the transpose graph in the reference); each growth step
yields the edge set for one earlier layer.
"""
from __future__ import annotations

import numpy as np

from gala_tpu_torch.data.csr import HostCSR, coo_to_csr


def mask_subgraphs(g: HostCSR, train_mask: np.ndarray, n_layers: int) -> list[HostCSR]:
    """Per-layer training subgraphs [layer0, ..., layerL-1].

    Layer L-1 (closest to the loss) keeps edges into masked nodes; each
    earlier layer keeps edges into the mask grown by one more hop.
    """
    masks = [np.asarray(train_mask, dtype=bool)]
    for _ in range(n_layers - 1):
        m = masks[-1]
        if g.n_edges > 1_000_000:
            from gala_tpu_torch import native

            grown = native.grow_mask_native(g.src, g.dst, m)
            if grown is not None:
                masks.append(grown)
                continue
        grown = m.copy()
        # nodes feeding a masked destination are needed one hop earlier
        grown[g.src[m[g.dst]]] = True
        masks.append(grown)
    # masks[k] = nodes needed at depth k from the loss; layer i uses
    # masks[n_layers-1-i] as its destination set
    subs = []
    for li in range(n_layers):
        dst_mask = masks[n_layers - 1 - li]
        keep = dst_mask[g.dst]
        subs.append(
            coo_to_csr(g.src[keep], g.dst[keep], g.vals[keep], g.n_rows, g.n_cols)
        )
    return subs
