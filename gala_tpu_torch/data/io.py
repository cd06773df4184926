"""Dataset IO in the GALA npy layout.

Layout produced by the reference's export script
(reference: scripts/Data/gala_export_npy.py:60-160) and consumed by
`readSM_npy32`/`readDM_npy` (reference: tests/common.h:293-430):

    <dir>/Adj_src.npy : uint32 [n_rows, n_cols, row_id_0, row_id_1, ...]
    <dir>/Adj_dst.npy : uint32 [col_id_0, col_id_1, ...]
    <dir>/Feat.npy    : float32 (N, F)
    <dir>/Lab.npy     : int64   (N, 1)
    <dir>/TnMsk.npy, VlMsk.npy, TsMsk.npy : int32 (N, 1)

CSR rows are aggregation *outputs* (destinations); edge values are all 1
(`set_all(1)`, reference: tests/common.h:366).  Self loops were normalized
(removed then re-added) at export time.
"""
from __future__ import annotations

import os

import numpy as np

from gala_tpu_torch.data.csr import HostCSR, coo_to_csr


def load_gala_graph(path: str) -> HostCSR:
    """Load Adj_src/Adj_dst npys into a dst-sorted HostCSR, vals := 1."""
    adj_src = np.load(os.path.join(path, "Adj_src.npy"))
    adj_dst = np.load(os.path.join(path, "Adj_dst.npy"))
    n_rows = int(adj_src[0])
    n_cols = int(adj_src[1])
    row_ids = adj_src[2:].astype(np.int64)
    col_ids = adj_dst.astype(np.int64)
    return coo_to_csr(src=col_ids, dst=row_ids, vals=None, n_rows=n_rows, n_cols=n_cols)


def load_gala_npy(path: str):
    """Load a full GALA-layout dataset directory.

    Returns (HostCSR, feats (N,F) f32, labels (N,) i64, masks dict of bool).
    """
    g = load_gala_graph(path)
    feats = np.load(os.path.join(path, "Feat.npy")).astype(np.float32)
    labels = np.load(os.path.join(path, "Lab.npy")).reshape(-1).astype(np.int64)
    masks = {}
    for key, fname in (("train", "TnMsk.npy"), ("val", "VlMsk.npy"), ("test", "TsMsk.npy")):
        m = np.load(os.path.join(path, fname)).reshape(-1)
        masks[key] = m.astype(bool)
    return g, feats, labels, masks


def save_gala_npy(path: str, g: HostCSR, feats, labels, masks) -> None:
    """Write a dataset in the GALA npy layout (inverse of load_gala_npy)."""
    os.makedirs(path, exist_ok=True)
    header = np.asarray([g.n_rows, g.n_cols], dtype=np.uint32)
    np.save(os.path.join(path, "Adj_src.npy"), np.concatenate([header, g.dst.astype(np.uint32)]))
    np.save(os.path.join(path, "Adj_dst.npy"), g.src.astype(np.uint32))
    np.save(os.path.join(path, "Feat.npy"), np.asarray(feats, dtype=np.float32))
    np.save(os.path.join(path, "Lab.npy"), np.asarray(labels, dtype=np.int64).reshape(-1, 1))
    for key, fname in (("train", "TnMsk.npy"), ("val", "VlMsk.npy"), ("test", "TsMsk.npy")):
        np.save(
            os.path.join(path, fname),
            np.asarray(masks[key], dtype=np.int32).reshape(-1, 1),
        )
