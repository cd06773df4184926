"""MatrixMarket (.mtx) IO.

Clean-room equivalent of the reference's MtxIO reader/writer
(reference: src/utils/mtx_io.h:38-819, tests/common.h:443 writeSM_mtx):
coordinate-format real/pattern matrices, general or symmetric, 1-based.
"""
from __future__ import annotations

import numpy as np

from gala_tpu_torch.data.csr import HostCSR, coo_to_csr


def read_mtx(path: str) -> HostCSR:
    with open(path) as f:
        header = f.readline().strip().lower()
        if not header.startswith("%%matrixmarket matrix coordinate"):
            raise ValueError(f"unsupported MatrixMarket header: {header}")
        pattern = "pattern" in header
        symmetric = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(v) for v in line.split())
        data = np.loadtxt(f, ndmin=2, max_rows=nnz)
    if data.size == 0:
        rows = cols = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float32)
    else:
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = (
            np.ones(rows.shape[0], np.float32)
            if pattern or data.shape[1] < 3
            else data[:, 2].astype(np.float32)
        )
    if symmetric:
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols_full = np.concatenate([cols, data[:, 0][off].astype(np.int64) - 1])
        vals = np.concatenate([vals, vals[off]])
        cols = cols_full
    # mtx (row, col) -> our (dst, src): CSR rows are aggregation outputs
    return coo_to_csr(src=cols, dst=rows, vals=vals, n_rows=n_rows, n_cols=n_cols)


def write_mtx(path: str, g: HostCSR) -> None:
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{g.n_rows} {g.n_cols} {g.n_edges}\n")
        for d, s, v in zip(g.dst, g.src, g.vals):
            f.write(f"{d + 1} {s + 1} {v:g}\n")
